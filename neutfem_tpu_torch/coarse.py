"""Coarse meshes, volume-averaged cross sections and the coarse-grid
initialization of the power iteration (port of ``neutfem_tpu/coarse.py``).

The coarse mesh subsamples the breakpoints by integer factors; the cross
sections are volume-averaged over each block of fine cells (arithmetic mean, D
included, as the reference's ``SolveCoarse``, NeutFEM.cpp:2475-2543).  The
two-grid preconditioner (``twogrid.py``) rediscretizes the RT0-P0 Schur
complement there; ``coarse_init`` (``NeutFEM::SolveCoarse``,
NeutFEM.cpp:2380-2611) solves the coarse RT0-P0 eigenproblem at relaxed
tolerances (x10, half the outer budget, NeutFEM.cpp:2460-2461) and injects the
coarse flux into the fine P_0 mode, higher modes zero (NeutFEM.cpp:2598-2603).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .mesh import CartesianMesh
from .native import block_mean

__all__ = ["coarsen_xs", "coarse_init", "default_coarse_factors"]


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


def coarse_init(fes, ng: int, xs: Dict[str, np.ndarray], bcs, factors: Sequence[int], opts,
                device, dtype, keff0: float = 1.0, marshak_d_factor: bool = False,
                coarse_a_mode: str = "exact"):
    """Solve the coarse RT0-P0 eigenproblem and return (keff_coarse, fine phi0).

    phi0 (ng, nz, ny, nx, P) on ``device`` carries the coarse flux in the fine
    P_0 mode (piecewise-constant prolongation) and zeros in the higher modes,
    ready to seed ``power_iteration`` on the fine space.  The coarse solve runs
    the equilibrated CG where ``opts.inner_solver`` is "direct" (the coarse
    context carries no dense factors), with the A-solve ``coarse_a_mode`` (the
    reference's coarse solve takes the standard exact Schur path,
    NeutFEM.cpp:2568).

    Under a sharding scope (``fes`` the whole problem's space, as in
    ``parallel.sharded_power_iteration``) every rank solves the whole coarse
    RT0-P0 problem itself, with the scope suspended: no collective, and the
    same bits on every rank, since no kernel uses atomics.  That is the
    design, not a fallback: the coarse problem is small (38x38x19 cells for
    factors (3, 3, 4) on IAEA-3D 6x6x4), so cutting it would cost more in
    collectives than it saves.  Each rank then returns k and its slab of
    the prolonged flux, ready for ``parallel.sharded_power_iteration``."""
    from .fespace import make_fespace
    from .ops.context import build_context
    from .power import power_iteration
    from .shardctx import current_sharding, no_sharding, take_slab

    mesh = fes.mesh
    cmesh, cxs = coarsen_xs(mesh, xs, factors)
    cfes = make_fespace(cmesh, 0, 0)  # coarse is always RT0-P0 (NeutFEM.cpp:2453-2458)
    copts = dataclasses.replace(opts, tol_keff=opts.tol_keff * 10.0,
                                tol_flux=opts.tol_flux * 10.0,
                                max_outer=max(opts.max_outer // 2, 2), a_mode=coarse_a_mode,
                                use_cmfd=False,
                                inner_solver="cg" if opts.inner_solver == "direct"
                                else opts.inner_solver)
    sh = current_sharding()
    with no_sharding():
        cctx = build_context(cfes, ng, cxs, bcs, device=device, dtype=dtype,
                             a_mode=coarse_a_mode, marshak_d_factor=marshak_d_factor)
        cphi0 = torch.ones((ng, *cmesh.shape, 1), dtype=dtype, device=device)
        res = power_iteration(cfes, ng, copts, cctx, cphi0, keff0)

    rx, ry, rz = factors
    fine_bar = res["phi"][..., 0]  # (ng, nzc, nyc, nxc)
    for ax, r in ((1, rz if mesh.dim == 3 else 1), (2, ry if mesh.dim >= 2 else 1), (3, rx)):
        fine_bar = torch.repeat_interleave(fine_bar, r, dim=ax)
    if sh is not None:
        fine_bar = take_slab(fine_bar, *sh, 1)
    phi0 = torch.zeros((*fine_bar.shape, fes.P), dtype=dtype, device=device)
    phi0[..., 0] = fine_bar
    return res["keff"], phi0
