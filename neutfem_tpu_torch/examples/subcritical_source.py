"""Subcritical source-driven system: its amplification factor and flux map.

The port of ``examples/subcritical_source.py``: a 2D two-group 100 x 100 cm
square of 20 x 20 cells, vacuum on every face, loaded below critical, with
a point source in the fast group at its centre.  ``SolveKeff`` gives k < 1;
after ``reset_flux`` the source solve at k = 1 gives the amplification M.
``python -m neutfem_tpu_torch.examples.subcritical_source [--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..compat import BCType, NeutFEM

N = 20


def main(device="cuda", dtype=None) -> dict:
    """Build and solve the system; prints k, M and the peak to source-cell
    flux ratio and returns them as ``{"keff", "M", "peak_ratio"}``."""
    n = N
    s = NeutFEM(0, 2, np.linspace(0, 100, n + 1), np.linspace(0, 100, n + 1), np.array([0.0]),
                device=device, dtype=dtype)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    s.get_D()[0], s.get_D()[1] = 1.4, 0.4
    s.get_SigR()[0], s.get_SigR()[1] = 0.028, 0.10
    s.get_NSF()[0], s.get_NSF()[1] = 0.003, 0.07   # subcritical loading
    s.get_Chi()[0] = 1.0
    s.get_SigS()[1, 0] = 0.018
    s.get_SRC()[0, n // 2, n // 2] = 1.0            # point source, fast group
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-7, 1e-9, 300)

    k = s.SolveKeff()
    s.reset_flux()
    M = s.SolveSubcritical()
    flux = s.get_flux()[0]
    ratio = float(flux.max() / flux[n // 2, n // 2])
    print(f"k-eff = {k:.5f} (subcritical), amplification M = {M:.3f}")
    print(f"peak/source-cell flux ratio: {ratio:.3f}")
    return {"keff": k, "M": M, "peak_ratio": ratio}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
