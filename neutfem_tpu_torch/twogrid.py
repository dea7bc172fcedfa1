"""Additive two-grid preconditioner for the Schur CG group solves.

Port of ``neutfem_tpu/twogrid.py``.  The preconditioner is a FIXED SPD linear
operator, so plain CG stays valid:

    M^-1 = B_fine  +  E_f P E_c p(S_c_eq) E_c P^T E_f

* ``B_fine``: the fine-level preconditioner (the identity on the equilibrated
  RT0 system, the P x P block-Jacobi for higher orders);
* ``P``: piecewise-constant prolongation into the fine P_0 mode, ``P^T`` its
  exact transpose (the sum over each block of child cells of the mode-0
  residual).  The JAX package writes both as per-axis matrix products to avoid
  TPU lane padding; here they are reshape-and-sum and expand-and-reshape;
* ``E_f = diag(S_fine)^{1/2}``, ``E_c = diag(S_c)^{-1/2}``: the group solves
  run on symmetrically equilibrated systems (``power.group_solve``);
* the coarse inverse, in one of two SPD forms:

  - ``mode="dense"`` (default): the exact equilibrated coarse inverse
    ``inv(E_c S_c E_c)``, made once at build time (``ops.direct.
    dense_schur_group`` and one Cholesky solve against the identity) and
    applied as one matrix-vector product per CG iteration, stored bfloat16
    when the solve dtype is float32.  The product is a plain library product,
    as the JAX package leaves it to XLA outside any kernel;
  - ``mode="cheby"``: a degree-k Chebyshev polynomial in the equilibrated
    coarse Schur on [lmax/kappa, lmax], lmax estimated per group by power
    iteration at build time; k coarse Schur matvecs per application.

The coarse operator is the RT0-P0 Schur rediscretized on volume-averaged
cross sections (``coarse.coarsen_xs``), built by ``ops.context.build_context``.

The compat layer attaches the dense form on 2D meshes of 65,536 cells or more
(``auto_twogrid``), the JAX package's measured rule; ``power.group_solve``'s
"auto" then resolves to "twogrid".
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .coarse import coarsen_xs, default_coarse_factors
from .fespace import FESpace, make_fespace
from .krylov import drop_plans
from .mesh import CartesianMesh

__all__ = ["attach_twogrid", "auto_twogrid", "coarse_fespace", "twogrid_correction",
           "twogrid_apply", "default_tg_factors", "dense_tg_factors", "tg_factors_of",
           "AUTO_TG_MIN_CELLS", "DENSE_MAX_NC"]

#: The JAX package's measured 2D crossover (``neutfem_tpu/twogrid.py:97-114``):
#: the dense correction is attached by default on 2D meshes of at least this
#: many cells.
AUTO_TG_MIN_CELLS = 65536

#: Default dense-inverse cap: coarse cells per group (n_c^2 bf16 = 128 MB at the cap).
DENSE_MAX_NC = 8192


def auto_twogrid(mesh: CartesianMesh) -> bool:
    """True when the auto rule wants the dense two-grid correction attached:
    2D (or 1D) meshes of >= AUTO_TG_MIN_CELLS cells with a dense-affordable
    coarsening."""
    return (mesh.dim <= 2 and mesh.n_elements >= AUTO_TG_MIN_CELLS
            and dense_tg_factors(mesh, DENSE_MAX_NC) != (1, 1, 1))


def default_tg_factors(mesh: CartesianMesh, max_factor: int = 4) -> Tuple[int, int, int]:
    """Largest factor <= max_factor dividing each active axis."""
    return default_coarse_factors(mesh, max_factor)


def dense_tg_factors(mesh: CartesianMesh, dense_max: int) -> Tuple[int, int, int]:
    """Smallest coarsening whose coarse cell count fits the dense cap — the
    richest coarse space whose exact inverse is still affordable.  Returns
    (1, 1, 1) when nothing fits."""
    nz, ny, nx = mesh.shape
    for max_factor in (2, 3, 4, 6, 8, 12, 16, 24, 32):
        f = default_coarse_factors(mesh, max_factor)
        fx, fy, fz = f
        if all(v == 1 for v in f):
            continue
        if (nx // fx) * (ny // fy) * (nz // fz) <= dense_max:
            return f
    return (1, 1, 1)


def coarse_fespace(fes: FESpace, factors: Tuple[int, int, int]) -> FESpace:
    """The RT0-P0 space on the subsampled mesh."""
    mesh = fes.mesh
    fx, fy, fz = factors
    xb = mesh.x_breaks[::fx]
    yb = mesh.y_breaks[::fy] if mesh.dim >= 2 else None
    zb = mesh.z_breaks[::fz] if mesh.dim == 3 else None
    return make_fespace(CartesianMesh.from_breaks(xb, yb, zb), 0, 0)


def _coarse_matvec(cfes: FESpace, cctx: Dict, sdi_c, fused: bool = True):
    """v -> E_c S_c E_c v, the equilibrated coarse Schur."""
    from .ops.apply import schur_matvec

    return lambda v: sdi_c * schur_matvec(cfes, cctx, v * sdi_c, a_mode="exact", fused=fused)


def _estimate_lmax(cfes: FESpace, cctx: Dict, ng: int, iters: int = 30):
    """(ng,) largest eigenvalue of each group's equilibrated coarse Schur, by
    power iteration from the JAX package's deterministic start vector, with a
    5% safety margin so the Chebyshev interval bounds the spectrum.  All
    groups at once through the unfused matvec (build time only)."""
    sdi = torch.sqrt(cctx["precond_inv"])  # (ng, 1, nz, ny, nx)
    matvec = _coarse_matvec(cfes, cctx, sdi, fused=False)
    ramp = torch.arange(sdi.numel(), dtype=sdi.dtype, device=sdi.device).reshape(sdi.shape)
    v = torch.ones_like(sdi) + 0.01 * torch.sin(ramp)  # deterministic, non-smooth
    tiny = torch.finfo(sdi.dtype).tiny
    nrm = None
    for _ in range(iters):
        w = matvec(v)
        nrm = torch.sqrt(torch.sum(w * w, dim=(-4, -3, -2, -1), keepdim=True))
        v = w / torch.clamp(nrm, min=tiny)
    return nrm.reshape(ng) * 1.05


def _dense_coarse_inv(cfes: FESpace, cctx: Dict, ng: int):
    """(ng, n_c, n_c) exact inverse of the equilibrated coarse Schur
    E_c S_c E_c (unit diagonal), per group: the dense Schur, then one SPD
    Cholesky solve against the identity, symmetrized.  Build time only."""
    from .ops.direct import dense_schur_group
    from .power import ctx_group

    mats = []
    for g in range(ng):
        cg = ctx_group(cctx, g)
        S = dense_schur_group(cfes, cg, "exact")
        sdi = torch.sqrt(cg["precond_inv"]).reshape(-1)
        shat = S * sdi[:, None] * sdi[None, :]
        del S
        chol = torch.linalg.cholesky(shat)
        eye = torch.eye(shat.shape[0], dtype=shat.dtype, device=shat.device)
        m = torch.cholesky_solve(eye, chol)
        mats.append(0.5 * (m + m.T))
        del shat, chol, eye, m
    return torch.stack(mats)


def attach_twogrid(
    fes: FESpace,
    ng: int,
    xs: Dict[str, np.ndarray],
    bcs,
    ctx: Dict,
    factors: Tuple[int, int, int] = None,
    marshak_d_factor: bool = False,
    mode: str = "dense",
    dense_max: int = DENSE_MAX_NC,
) -> Dict:
    """Build the coarse context and the coarse inverse and attach them as
    ``ctx["tg"]`` (on the device and in the dtype of ``ctx["C"]``).

    The nested dict holds a full ``build_context`` output plus EITHER
    ``schur_minv`` (ng, n_c, n_c), the dense equilibrated coarse inverse
    (bfloat16 when the solve dtype is float32), OR ``schur_lmax`` (ng,) for
    the Chebyshev form.  ``mode="dense"`` falls back to Chebyshev when the
    coarse cell count exceeds ``dense_max``; explicitly passed factors are
    honored, the default picks the richest dense-affordable coarsening.
    Leaves ``ctx`` untouched when no coarsening is possible."""
    from .ops.context import build_context

    mesh = fes.mesh
    if factors is None:
        factors = (dense_tg_factors(mesh, dense_max) if mode == "dense"
                   else default_tg_factors(mesh))
        if all(f == 1 for f in factors) and mode == "dense":
            factors = default_tg_factors(mesh)  # nothing dense-affordable
    if all(f == 1 for f in factors):
        return ctx
    cmesh, cxs = coarsen_xs(mesh, xs, factors)
    cfes = make_fespace(cmesh, 0, 0)
    C = ctx["C"]
    cctx = build_context(cfes, ng, cxs, bcs, device=C.device, dtype=C.dtype,
                         marshak_d_factor=marshak_d_factor)
    n_c = int(np.prod(cmesh.shape))
    drop_plans(ctx)  # their two-grid closures hold the level replaced here
    if mode == "dense" and n_c <= dense_max:
        minv = _dense_coarse_inv(cfes, cctx, ng)
        store = torch.bfloat16 if minv.dtype == torch.float32 else minv.dtype
        ctx["tg"] = {**cctx, "schur_minv": minv.to(store)}
    else:
        ctx["tg"] = {**cctx, "schur_lmax": _estimate_lmax(cfes, cctx, ng)}
    return ctx


def tg_factors_of(fes: FESpace, ctx_tg: Dict) -> Tuple[int, int, int]:
    """(fx, fy, fz) recovered from the coarse array shapes."""
    nzc, nyc, nxc = ctx_tg["C"].shape[-3:]
    nz, ny, nx = fes.mesh.shape
    return nx // nxc, ny // nyc, nz // nzc


def twogrid_apply(fes: FESpace, ctxg: Dict, opts) -> Callable:
    """The coarse-correction term as a function r -> E_f P E_c p(S_c_eq) E_c P^T E_f r
    of the equilibrated fine residual (internal layout (..., P, nz, ny, nx)).
    ``ctxg`` is group-sliced, or the whole context for the Jacobi sweep's
    batched solve (r then (ng, P, nz, ny, nx): the dense coarse inverse is
    applied per group, the Chebyshev form's coarse matvec runs every group at
    once).  Everything that does not depend on r (the coarse space, the
    scalings, the Chebyshev coefficients) is made once here, so a group solve
    builds it once and applies it every CG iteration."""
    tg = ctxg["tg"]
    fx, fy, fz = tg_factors_of(fes, tg)
    nz, ny, nx = fes.mesh.shape
    nzc, nyc, nxc = nz // fz, ny // fy, nx // fx
    inv_sdi_f = 1.0 / torch.sqrt(ctxg["precond_inv"])  # E_f = diag(S_f)^{1/2}
    sdi_c = torch.sqrt(tg["precond_inv"])              # E_c = diag(S_c)^{-1/2}
    inv_sdi_f0 = inv_sdi_f[..., 0, :, :, :]

    def restrict(r):
        """mode-0 plane, unscaled, summed over each block of child cells, then
        coarse-equilibrated: (..., 1, nzc, nyc, nxc)."""
        r0 = r[..., 0, :, :, :] * inv_sdi_f0
        lead = r0.shape[:-3]
        rc = r0.reshape(*lead, nzc, fz, nyc, fy, nxc, fx).sum(dim=(-5, -3, -1))
        return rc.unsqueeze(-4) * sdi_c

    def prolong(zc, r):
        """coarse-equilibrate back, replicate into the fine P_0 mode, rescale —
        the exact transpose of ``restrict``."""
        zc0 = (zc * sdi_c)[..., 0, :, :, :]
        lead = zc0.shape[:-3]
        z0 = zc0.reshape(*lead, nzc, 1, nyc, 1, nxc, 1).expand(
            *lead, nzc, fz, nyc, fy, nxc, fx).reshape(*lead, nz, ny, nx)
        out = torch.zeros_like(r)
        out[..., 0, :, :, :] = z0 * inv_sdi_f0
        return out

    minv = tg.get("schur_minv")
    if minv is not None:
        def coarse(rc):
            # one matrix-vector product against the stored inverse, in its
            # storage dtype (bf16 x bf16 with float32 accumulation on the card)
            s = rc.shape
            rflat = rc.reshape(*minv.shape[:-2], -1).to(minv.dtype)
            if minv.ndim == 3:  # the Jacobi sweep: one product per group
                zflat = (minv @ rflat.unsqueeze(-1)).squeeze(-1)
            else:
                zflat = minv @ rflat
            return zflat.to(rc.dtype).reshape(s)
    else:
        cfes = coarse_fespace(fes, (fx, fy, fz))
        matvec = _coarse_matvec(cfes, tg, sdi_c)
        lmax = tg["schur_lmax"]
        if lmax.ndim == 1:  # batched (leading ng): broadcast over (1, nz, ny, nx)
            lmax = lmax.reshape(-1, 1, 1, 1, 1)
        lmin = lmax / opts.tg_kappa
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta

        def coarse(rc):
            # degree-k Chebyshev approximate inverse (three-term recurrence;
            # z0 = 0, k coarse matvecs)
            d = rc / theta
            zc = d
            res = rc - matvec(d)
            rho = 1.0 / sigma
            for _ in range(max(opts.tg_degree - 1, 0)):
                rho_new = 1.0 / (2.0 * sigma - rho)
                d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
                zc = zc + d
                res = res - matvec(d)
                rho = rho_new
            return zc

    return lambda r: prolong(coarse(restrict(r)), r)


def twogrid_correction(fes: FESpace, ctxg: Dict, opts, r):
    """The coarse-correction term E_f P E_c p(S_c_eq) E_c P^T E_f r for one
    residual (the JAX package's function; ``twogrid_apply`` is its reusable
    form).  The caller adds the fine-level part."""
    return twogrid_apply(fes, ctxg, opts)(r)
