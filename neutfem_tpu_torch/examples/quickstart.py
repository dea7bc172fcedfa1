"""Quick start: a 1D two-group slab, reflective left, vacuum right.

The port of ``examples/quickstart.py`` (the README's example): 10 cells over
100 cm, one material, the fast group's fission source downscattering into
the thermal group.  ``python -m neutfem_tpu_torch.examples.quickstart
[--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..compat import BCType, BoundaryID, NeutFEM


def main(device="cuda", dtype=None) -> dict:
    """Build and solve the slab; prints k and the flux shape and returns
    ``{"keff": k, "flux_shape": shape}``."""
    solver = NeutFEM(order=0, ng=2, x_breaks=np.linspace(0, 100, 11),
                     y_breaks=np.array([0.0]), z_breaks=np.array([0.0]),
                     device=device, dtype=dtype)
    solver.get_D()[:] = 1.5
    solver.get_SigR()[:] = 0.02          # removal (absorption + out-scatter)
    solver.get_SigS()[1, 0, :] = 0.015   # fast -> thermal downscatter
    solver.get_NSF()[0, :] = 0.005
    solver.get_NSF()[1, :] = 0.02
    solver.get_Chi()[0, :] = 1.0
    solver.set_bc(BoundaryID.LEFT_1D, BCType.MIRROR)
    solver.set_bc(BoundaryID.RIGHT_1D, BCType.DIRICHLET, 0.0)
    solver.BuildMatrices()
    keff = solver.SolveKeff()
    shape = solver.get_flux().shape
    print(f"k-effective = {keff:.6f}")
    print(f"flux shape  = {shape}")
    return {"keff": keff, "flux_shape": tuple(shape)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
