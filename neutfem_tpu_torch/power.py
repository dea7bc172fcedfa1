"""Multigroup k-effective power iteration (port of ``neutfem_tpu/power.py``).

Rebuild of the reference ``NeutFEM::SolveKeff`` (NeutFEM.cpp:1627-1826), direct
mode: fission source, Gauss-Seidel-in-source group sweep with matrix-free Schur
CG group solves, eigenvalue update, normalization, branch-free Chebyshev
acceleration and the adaptive inner tolerance with its certification guard.

The JAX package runs the outer loop in one ``lax.while_loop``.  Here it is a
Python loop over device tensors with one host sync per outer iteration (the
stop test) and one per CG iteration (``krylov.pcg``); the control flow and the
arithmetic follow the JAX loop step for step, so outer and inner counts agree.

Ported: direct solves, ``inner_solver="cg"`` with the Jacobi (diag-S)
equilibration, ``accel`` "chebyshev" | "none".  Everything else the JAX
``SolveOptions`` offers raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .accel import chebyshev_apply_blend, chebyshev_init
from .fespace import FESpace
from .krylov import KrylovResult, pcg
from .ops.apply import (
    J_to_public,
    apply_BT_dir,
    phi_to_internal,
    phi_to_public,
    schur_matvec,
    solve_A_dir,
)

__all__ = ["SolveOptions", "ctx_group", "group_solve", "compute_current", "power_iteration"]


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Solver configuration (the ported subset of the JAX package's options)."""

    tol_keff: float = 1e-5
    tol_flux: float = 1e-5
    inner_tol: float = 1e-5       # Schur CG relative tolerance (= tol_flux in reference)
    inner_eta: float = 0.0        # > 0: adaptive inner tolerance, each outer's group
                                  # solves run at clip(inner_eta * dphi_prev,
                                  # inner_tol, 0.1); 0 = fixed tolerance
    max_outer: int = 200
    max_inner: int = 1000
    accel: str = "chebyshev"      # "none" | "chebyshev"
    cheby_nmax: int = 15
    cheby_sigma: float = 0.98
    a_mode: str = "exact"
    warm_start: bool = True
    inner_solver: str = "cg"
    inner_precond: str = "auto"   # "jacobi" | "auto" (= jacobi below 3M cells, where
                                  # the JAX package picks its line preconditioner)
    use_cmfd: bool = False
    sweep: str = "gs"


def ctx_group(ctx: Dict, g: int) -> Dict:
    """Slice the per-group arrays of the operator context for group g."""
    out = {}
    for k, v in ctx.items():
        if isinstance(v, dict):
            out[k] = ctx_group(v, g)
        elif k.startswith(("C", "alpha_", "tri_", "precond", "cyc_", "src_bc",
                           "jcorr_", "schur_")):
            out[k] = v[g]
        else:
            out[k] = v
    return out


def group_solve(fes: FESpace, ctxg: Dict, opts: SolveOptions, rhs, x0, tol=None) -> KrylovResult:
    """Solve S_g phi_g = rhs by CG on the symmetrically Jacobi-equilibrated system
    D^-1/2 S D^-1/2 y = D^-1/2 rhs with D = exact diag(S): every Krylov
    intermediate is O(1), which float32 needs with the 1e15 void absorbers of
    the IAEA-3D filler.  ``tol`` (0-d tensor) overrides ``opts.inner_tol``."""
    if opts.inner_solver != "cg":
        raise NotImplementedError(f"inner_solver={opts.inner_solver!r} is not ported")
    pc_mode = opts.inner_precond
    if pc_mode == "auto":
        # the JAX package's rule: line preconditioner from 3M cells, else jacobi
        pc_mode = "line" if fes.mesh.n_elements >= 3_000_000 else "jacobi"
    if pc_mode != "jacobi":
        raise NotImplementedError(f"inner_precond={pc_mode!r} is not ported")
    sdi = torch.sqrt(ctxg["precond_inv"])  # D^-1/2

    def matvec(y):
        return sdi * schur_matvec(fes, ctxg, y * sdi, a_mode=opts.a_mode)

    res = pcg(matvec, rhs * sdi, x0 / sdi,
              tol=opts.inner_tol if tol is None else tol, maxiter=opts.max_inner)
    return res._replace(x=res.x * sdi)


def _fission_source(ctx, phi):
    """total_fiss = sum_g (nuSigf_g-weighted mass) phi_g (NeutFEM.cpp:1700-1707).
    phi internal (ng, P, sp); returns (P, sp)."""
    w = ctx["nsf"] * ctx["detJ"]  # (ng, nz, ny, nx)
    return torch.sum(w.unsqueeze(-4) * (ctx["w_mode_col"] * phi), dim=0)


def _production(ctx, phi):
    """Reference 'production' functional: total of F phi."""
    w = ctx["nsf"] * ctx["detJ"]
    return torch.sum(w.unsqueeze(-4) * (ctx["w_mode_col"] * phi))


def _scatter_into(ctx, g: int, phi):
    """sum_{g' != g} (SigS[g<-g']-weighted mass) phi_g'  (NeutFEM.cpp:1719-1726)."""
    out = 0.0
    for gp in range(phi.shape[0]):
        if gp == g:
            continue
        w = ctx["sigs"][g, gp] * ctx["detJ"]  # (nz, ny, nx): broadcasts against (P, sp)
        out = out + w * (ctx["w_mode_col"] * phi[gp])
    return out


def compute_current(fes: FESpace, ctx: Dict, phi, a_mode: str = "exact"):
    """J = A^{-1} B^T phi for all groups (internal layout), one batched Thomas
    solve per direction."""
    J = {}
    for di in fes.dirs:
        key = f"d{di.d}"
        rF, rW = apply_BT_dir(fes, di, phi)
        F, _ = solve_A_dir(fes, di, ctx[f"tri_dinv_{key}"], ctx[f"tri_l_{key}"],
                           ctx[f"mask_{key}"], ctx[f"alpha_{key}"], rF, rW, a_mode)
        J[key] = {"face": F}
    return J


def power_iteration(fes: FESpace, ng: int, opts: SolveOptions, ctx: Dict, phi0, keff0,
                    adjoint: bool = False):
    """Run the accelerated power iteration.  Returns a result dict.

    phi0: (ng, nz, ny, nx, P) initial flux (public layout, on the context's
    device); keff0: initial eigenvalue."""
    if adjoint:
        raise NotImplementedError("adjoint solves are not ported")
    if opts.use_cmfd:
        raise NotImplementedError("CMFD is not ported")
    if opts.sweep != "gs":
        raise NotImplementedError(f"sweep={opts.sweep!r} is not ported")
    if opts.accel not in ("chebyshev", "none"):
        raise NotImplementedError(f"accel={opts.accel!r} is not ported")

    phi = phi_to_internal(phi0)
    dtype, device = phi.dtype, phi.device

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    use_cheby = opts.accel == "chebyshev"
    cheby_from = 2
    cheb = chebyshev_init(phi)
    # Adaptive-schedule endgame floor: an outer solved at tolerance tol_g cannot
    # certify flux accuracy better than ~tol_g, so convergence only counts once
    # the schedule has tightened to this floor (without it a loose early solve
    # fakes a tiny dphi/dk and the iteration stops on the wrong eigenpair).
    endgame_tol = max(opts.inner_tol, 0.1 * opts.tol_flux) * 1.0001

    keff = scalar(keff0)
    diff_k, diff_flux, tol_used = scalar(1.0), scalar(1.0), scalar(1.0)
    it, inner_tot, last_inner = 0, 0, 0
    last_resid = scalar(0.0)
    hist = []

    def not_converged() -> bool:
        nc = (diff_k >= opts.tol_keff) | (diff_flux >= opts.tol_flux)
        if opts.inner_eta > 0:
            nc = nc | (tol_used > endgame_tol)
        return bool(nc)  # the one host sync per outer iteration

    # always run at least 2 iterations (k is not updated at it=0)
    while it < opts.max_outer and (it < 2 or not_converged()):
        phi_old = phi
        tol_g = None
        tol_used = scalar(opts.inner_tol)
        if opts.inner_eta > 0:
            tol_g = torch.clamp(scalar(opts.inner_eta) * diff_flux, opts.inner_tol, 0.1)
            tol_used = tol_g

        total_fiss = _fission_source(ctx, phi)
        prod_old = torch.sum(total_fiss)

        inner_iters = 0
        phi = phi.clone()
        for g in range(ng):
            ctxg = ctx_group(ctx, g)
            rhs = ctx["chi"][g] * total_fiss / keff
            rhs = rhs + _scatter_into(ctx, g, phi)
            x0 = phi[g] if opts.warm_start else torch.zeros_like(phi[g])
            res = group_solve(fes, ctxg, opts, rhs, x0, tol=tol_g)
            phi[g] = res.x
            inner_iters += res.iterations
            last_inner = res.iterations
            last_resid = res.residual

        prod_new = _production(ctx, phi)
        safe_old = torch.where(prod_old == 0, 1.0, prod_old)
        keff_new = keff * prod_new / safe_old
        diff_k = torch.abs(keff_new - keff)
        if it >= 1:
            keff = keff_new

        sol_norm_sq = torch.sum(phi * phi)
        diff_norm_sq = torch.sum((phi - phi_old) ** 2)
        diff_flux = torch.sqrt(diff_norm_sq / torch.where(sol_norm_sq == 0, 1.0, sol_norm_sq))
        norm = torch.sqrt(sol_norm_sq)
        phi = phi / torch.where(norm > 1e-14, norm, 1.0)

        if use_cheby:
            cheb, phi = chebyshev_apply_blend(cheb, phi, it >= cheby_from,
                                              opts.cheby_nmax, opts.cheby_sigma)
        hist.append(torch.stack([keff, diff_k, diff_flux, scalar(float(inner_iters))]))
        it += 1
        inner_tot += inner_iters

    J = compute_current(fes, ctx, phi, a_mode=opts.a_mode)
    return {
        "keff": keff,
        "phi": phi_to_public(phi),
        "J": J_to_public(J),
        "outer_iterations": it,
        "inner_iterations": inner_tot,
        "last_inner_iterations": last_inner,
        "last_inner_residual": last_resid,
        "diff_k": diff_k,
        "diff_flux": diff_flux,
        # (outer_iterations, 4) per-outer history [k, dk, dphi, inner iters]
        "history": torch.stack(hist) if hist else torch.zeros((0, 4), dtype=dtype),
        "finite": torch.isfinite(keff) & torch.all(torch.isfinite(phi)),
    }
