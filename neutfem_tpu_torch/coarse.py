"""Coarse meshes and volume-averaged cross sections (port of ``neutfem_tpu/coarse.py``).

The two-grid preconditioner (``twogrid.py``) rediscretizes the RT0-P0 Schur
complement on a coarse mesh: the breakpoints subsampled by integer factors and
the cross sections volume-averaged over each block of fine cells (arithmetic
mean, D included, as the reference's ``SolveCoarse``, NeutFEM.cpp:2475-2543).
The coarse-grid initialization of the power iteration (``coarse_init``) is not
ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .mesh import CartesianMesh
from .native import block_mean

__all__ = ["coarsen_xs", "default_coarse_factors"]


def default_coarse_factors(mesh: CartesianMesh, max_factor: int = 4) -> Tuple[int, int, int]:
    """Largest factor <= max_factor dividing each active axis, (x, y, z) order
    (the convention of the reference benchmark scripts, tests/iaea2d/iaea2d.py:170-181)."""
    out = []
    for n, active in ((mesh.nx, True), (mesh.ny, mesh.dim >= 2), (mesh.nz, mesh.dim == 3)):
        f = 1
        if active:
            for cand in range(min(max_factor, n), 0, -1):
                if n % cand == 0:
                    f = cand
                    break
        out.append(f)
    return tuple(out)


def coarsen_xs(mesh: CartesianMesh, xs: Dict[str, np.ndarray],
               factors) -> Tuple[CartesianMesh, Dict[str, np.ndarray]]:
    """The coarse mesh (subsampled breakpoints) and the volume-averaged XS."""
    rx, ry, rz = factors
    if mesh.nx % rx or (mesh.dim >= 2 and mesh.ny % ry) or (mesh.dim == 3 and mesh.nz % rz):
        raise ValueError(f"coarse factors {factors} must divide the mesh {mesh.shape}")
    xb = mesh.x_breaks[::rx]
    yb = mesh.y_breaks[::ry] if mesh.dim >= 2 else None
    zb = mesh.z_breaks[::rz] if mesh.dim == 3 else None
    cmesh = CartesianMesh.from_breaks(xb, yb, zb)

    fac = (rx, ry if mesh.dim >= 2 else 1, rz if mesh.dim == 3 else 1)
    vols = mesh.volumes()
    cxs = {key: block_mean(np.asarray(xs[key], dtype=np.float64), vols, fac)
           for key in ("D", "SigR", "NSF", "KSF", "Chi", "SRC", "SigS") if key in xs}
    return cmesh, cxs
