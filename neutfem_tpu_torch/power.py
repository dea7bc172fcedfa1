"""Multigroup k-effective power iteration (port of ``neutfem_tpu/power.py``).

Rebuild of the reference ``NeutFEM::SolveKeff`` (NeutFEM.cpp:1627-1826) and
``SolveAdjoint`` (NeutFEM.cpp:1877-2082): fission source, group sweep with
matrix-free Schur CG group solves, eigenvalue update, normalization,
branch-free Chebyshev acceleration, CMFD correction and the adaptive inner
tolerance with its certification guard.

The JAX package runs the outer loop in one ``lax.while_loop``.  Here it is a
Python loop over device tensors with one host sync per outer iteration (the
stop test) and one per block of CG iterations (``krylov``: on the card a
captured graph of ``krylov.BLOCK_ITERS`` iterations, made once per context,
group and path, ``group_plan``); the control flow and the arithmetic follow
the JAX loop step for step, so outer and inner counts agree.

Ported: direct and adjoint solves (transposed couplings, reverse group sweep,
optionally at a fixed eigenvalue), the Gauss-Seidel ("gs") and the Jacobi
("jacobi": every group in one batched CG) group sweeps, ``inner_solver``
"cg" on the Jacobi (diag-S) equilibrated system with the identity
(``"jacobi"``), the P x P block-Jacobi (``"block"``, k >= 1), the
line-tridiagonal (``"line"``, ``"line2"``, P == 1) or the additive two-grid
(``"twogrid"``, ``twogrid.py``) preconditioner, and ``inner_solver``
"direct" (the dense Cholesky factors of ``ops/direct.py``); ``accel``
"chebyshev" | "anderson" | "none"; CMFD (``cmfd.py``) in mode "fixed"; the
fixed-source and subcritical solves (``fixed_source_solve``,
``solve_subcritical``).  Everything else the JAX ``SolveOptions`` offers
raises ``NotImplementedError``.

The JAX package's opt-in switches select the same branches here (read at
each group solve, as the JAX package reads them at trace time):
``NEUTFEM_EQFOLD=1|2`` the equilibration-folded matvec (``ops/fused_eq.py``,
K7), ``NEUTFEM_CGCG=1`` the Chronopoulos-Gear CG (``krylov.pcg_fused``),
``NEUTFEM_BLOCKJAC=1`` the fused block-Jacobi apply + dots
(``ops/blockjac.py``, K8) where the block inverse is stored as
``precond_blk_inv``; ``NEUTFEM_BLKFP8`` is read by ``ops/context.py``.  The
default float32 block preconditioner (the fp8 E-form ``precond_blk_dev``)
runs through the same kernel, ``blockjac_dev_dots``, on one group's solve.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch

from .accel import anderson_apply, anderson_init, chebyshev_apply_blend, chebyshev_init
from .cmfd import cmfd_correction
from .fespace import GRID_AXIS, FESpace
from .krylov import (CG_PLANS, CGGraph, CGPlans, KrylovResult, pcg, pcg_blocks, pcg_fused,
                     pcg_fused_blocks)
from .ops.apply import (
    J_to_public,
    apply_BT_dir,
    eqfold_available,
    equilibrated_schur_matvec,
    phi_to_internal,
    phi_to_public,
    schur_matvec,
    solve_A_dir,
)
from .ops.blockjac import blockjac_dev_dots, blockjac_dots
from .ops.direct import direct_solve
from .ops.tridiag import tridiag_solve
from .twogrid import twogrid_apply

__all__ = ["SolveOptions", "ctx_group", "resolve_precond", "group_plan", "group_solve",
           "compute_current", "power_iteration", "biorthogonal_inner", "CGPlan",
           "fixed_source_solve", "solve_subcritical"]


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
    accel: str = "chebyshev"      # "none" | "chebyshev" | "anderson"
    cheby_nmax: int = 15
    cheby_sigma: float = 0.98
    anderson_m: int = 4
    a_mode: str = "exact"
    warm_start: bool = True
    inner_solver: str = "cg"      # "cg" | "direct" (ops/direct.attach_dense_schur
                                  # must have put the dense factors on the context)
    inner_precond: str = "auto"   # "jacobi" | "block" | "line" | "line2" |
                                  # "twogrid" | "auto" (resolve_precond: twogrid
                                  # when a coarse level is attached and P == 1,
                                  # block when P > 1, line from 3M cells, else
                                  # jacobi — the JAX package's rule)
    tg_degree: int = 8            # twogrid, Chebyshev form: polynomial degree
                                  # (= coarse matvecs per CG iteration)
    tg_kappa: float = 30.0        # twogrid, Chebyshev form: interval [lmax/kappa, lmax]
    use_cmfd: bool = False        # CMFD nonlinear acceleration (excludes Chebyshev)
    cmfd_omega: float = 1.0       # CMFD correction relaxation (SetCMFDRelaxation)
    cmfd_from_iter: int = 2       # first outer with CMFD (NeutFEM.cpp:1750)
    cmfd_mode: str = "fixed"      # "fixed" (ported) | "wielandt" (not ported)
    cmfd_use_lo_k: bool = False   # take keff from the lo solve (its k is the
                                  # current one in mode "fixed")
    cmfd_lo_outers: int = 60      # wielandt-mode cap on lo iterations (not ported)
    sweep: str = "gs"             # "gs" (reference Gauss-Seidel) | "jacobi" (all
                                  # groups in ONE batched Schur CG; no Chebyshev)


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


def _block_source(ctxg: Dict):
    """The stored block operand of ``_block_precond`` as a cells-major view,
    (groups, cells, P, P), or None when the context has no block inverse."""
    deviation = "precond_blk_dev" in ctxg
    stored = ctxg.get("precond_blk_dev" if deviation else "precond_blk_inv")
    if stored is None:
        return None
    P = stored.shape[-5]
    cells = stored.shape[-3] * stored.shape[-2] * stored.shape[-1]
    return stored.reshape(-1, P, P, cells).permute(0, 3, 1, 2)


def _block_precond(ctxg: Dict, dtype, blks: Optional[torch.Tensor] = None):
    """The P x P block-Jacobi apply on the equilibrated system, or None when the
    context has no block inverse.  ``group_solve`` takes it where the K8 kernel
    (``ops/blockjac.py``) does not serve: float64, the Jacobi sweep's batched
    (ng, ...) solve, ``pcg_fused`` under ``NEUTFEM_CGCG=1``, a coarse
    correction on top, and the bf16 inverse without ``NEUTFEM_BLOCKJAC=1``.
    The stored operand (float8 E-form, bfloat16 or the working dtype; (P, P,
    nz, ny, nx) for one group, (ng, P, P, nz, ny, nx) for the Jacobi sweep's
    batched solve) is upcast to the flux dtype once
    per group solve — torch's batched products do not mix dtypes; the JAX
    package's bf16 x f32 einsum promotes to f32, so the numbers are the same —
    and laid out cells-major (cells, P, P) per group at the same time, so each
    apply is one batched matrix-vector product per group with no copy of the
    block tensor.  The vector operand stays a strided view of r: made
    contiguous as (cells, P, 1) it slowed the whole RT2-P2 4x4x2 float32
    solve from 73.9 to 125.8 ms/outer on an NVIDIA H100 (``bench.main_ho(2)``).

    ``blks``: that copy, (groups, cells, P, P) in ``dtype``, made by the
    caller (``group_plan``: a static buffer refilled before every solve);
    None: made here."""
    deviation = "precond_blk_dev" in ctxg
    src = _block_source(ctxg)
    if src is None:
        return None
    P = src.shape[-1]
    if blks is None:
        blks = src.to(dtype, memory_format=torch.contiguous_format)

    def one(blk, r):  # r (P, nz, ny, nx)
        return torch.bmm(blk, r.reshape(P, -1).T.unsqueeze(-1)).squeeze(-1).T.reshape(r.shape)

    def apply(r):
        z = one(blks[0], r) if r.ndim == 4 else torch.stack([one(b, rg) for b, rg in zip(blks, r)])
        # E-form: z = r + E r with E = Binv - I, the identity part applied exactly
        return (r + z if deviation else z).contiguous()

    return apply


#: Cell count from which "auto" picks the line preconditioner (the JAX
#: package's crossover, measured on IAEA-3D: ``neutfem_tpu/power.py:244-256``).
LINE_MIN_CELLS = 3_000_000


def resolve_precond(fes: FESpace, ctx: Dict, mode: str) -> str:
    """The preconditioner an ``inner_precond`` of ``mode`` runs, by the JAX
    package's "auto" rule in its order: a coarse level attached ("tg") with
    P == 1 -> twogrid; P > 1 -> block; 3M cells or more -> line; else jacobi."""
    if mode != "auto":
        return mode
    if fes.P == 1 and "tg" in ctx:
        return "twogrid"
    if fes.P > 1:
        return "block"
    return "line" if fes.mesh.n_elements >= LINE_MIN_CELLS else "jacobi"


def _line_precond(fes: FESpace, ctxg: Dict, pc_mode: str):
    """The line-tridiagonal preconditioner: one batched Thomas solve per CG
    iteration along the highest active direction (z in 3D, y in 2D) with the
    factors of ``build_context``; "line2" adds the next direction additively
    (M^-1 = M1^-1 + M2^-1, SPD as a sum of SPD solves).  None when the
    context has no line factors (P > 1), as in the JAX package."""
    if "precond_line_dinv" not in ctxg:
        return None
    pc_dirs = sorted((di.d for di in fes.dirs), reverse=True)
    names = ["line"] + (["line2"] if pc_mode == "line2" and len(pc_dirs) > 1
                        and "precond_line2_dinv" in ctxg else [])
    applies = []
    for name, d in zip(names, pc_dirs):
        dinv = ctxg[f"precond_{name}_dinv"].unsqueeze(-4)
        l = ctxg[f"precond_{name}_l"].unsqueeze(-4)
        ax = GRID_AXIS[d] - 3
        applies.append(lambda r, dinv=dinv, l=l, ax=ax: tridiag_solve(r, dinv, l, ax % r.ndim))
    if len(applies) == 1:
        return applies[0]
    return lambda r: applies[0](r) + applies[1](r)


@dataclasses.dataclass
class CGPlan:
    """One group solve's CG: ``solver`` (``pcg`` / ``pcg_fused``) with its
    eager block loop ``blocks`` (``pcg_blocks`` / ``pcg_fused_blocks``), the
    equilibrated operator, its preconditioner (``precond`` or the fused
    ``precond_dots``), D^-1/2 (``sdi``), the graph the solver replays on
    the card, and ``refill`` (or None), to run before every solve: it makes
    the static operands the plan shares with others (the block copy of
    ``_block_precond``)."""

    solver: Callable
    blocks: Callable
    matvec: Callable
    sdi: torch.Tensor
    precond: Optional[Callable]
    precond_dots: Optional[Callable]
    graph: CGGraph
    refill: Optional[Callable] = None

    def kwargs(self) -> Dict:
        return {"precond_dots": self.precond_dots} if self.precond_dots is not None else {}


def group_plan(fes: FESpace, ctxg: Dict, opts: SolveOptions, rhs) -> CGPlan:
    """The CG plan ``group_solve`` runs for ``rhs`` (see there).  On the card
    it is made once per (group, shape, dtype, path) and kept in the context's
    ``krylov.CGPlans`` when it has one; the path is the resolved
    preconditioner, the switches read here (``NEUTFEM_EQFOLD``,
    ``NEUTFEM_CGCG``, ``NEUTFEM_BLOCKJAC``), the options the operator depends
    on and ``max_inner``."""
    pc_mode = resolve_precond(fes, ctxg, opts.inner_precond)
    if pc_mode not in ("jacobi", "block", "line", "line2", "twogrid"):
        raise NotImplementedError(f"inner_precond={pc_mode!r} is not ported")
    env = tuple(os.environ.get(k, "") for k in ("NEUTFEM_EQFOLD", "NEUTFEM_CGCG",
                                                 "NEUTFEM_BLOCKJAC"))
    cache = ctxg.get(CG_PLANS) if rhs.device.type == "cuda" else None
    key = (ctxg["precond_inv"].data_ptr(), tuple(rhs.shape), rhs.dtype, pc_mode, env,
           opts.a_mode, opts.tg_degree, opts.tg_kappa, opts.max_inner)
    if cache is not None and key in cache.plans:
        return cache.plans[key]
    # the plan keeps this group's context without the plans (no cycle)
    ctxg = {k: v for k, v in ctxg.items() if k != CG_PLANS}
    if eqfold_available(fes, ctxg, rhs.shape, rhs.dtype, opts.a_mode):
        # the staged D^-1/2, so the scaling of rhs and x0 is the kernels' own
        sdi = ctxg["precond_eq_sdi"]

        def matvec(y):
            return equilibrated_schur_matvec(fes, ctxg, y, a_mode=opts.a_mode)
    else:
        sdi = torch.sqrt(ctxg["precond_inv"])  # D^-1/2

        def matvec(y):
            return sdi * schur_matvec(fes, ctxg, y * sdi, a_mode=opts.a_mode)
    cgcg = os.environ.get("NEUTFEM_CGCG", "0") == "1"
    solver, blocks = (pcg_fused, pcg_fused_blocks) if cgcg else (pcg, pcg_blocks)
    tg_corr = None
    if pc_mode == "twogrid":
        if "tg" in ctxg:
            tg_corr = twogrid_apply(fes, ctxg, opts)
        pc_mode = "block" if fes.P > 1 else "jacobi"
    precond = precond_dots = refill = None
    if pc_mode == "block":
        bi, dev = ctxg.get("precond_blk_inv"), ctxg.get("precond_blk_dev")
        # the fused apply + dots (K8) on one group's stored (P, P, nz, ny, nx)
        # blocks, for pcg on a float32 residual: no float32 copy of the
        # blocks is made
        fused = tg_corr is None and not cgcg and rhs.dtype == torch.float32
        if fused and dev is not None and dev.ndim == 5:
            precond_dots = lambda r: blockjac_dev_dots(dev, r)
        elif (fused and bi is not None and os.environ.get("NEUTFEM_BLOCKJAC", "0") == "1"
                and bi.dtype in (torch.float32, torch.bfloat16) and bi.ndim == 5):
            precond_dots = lambda r: blockjac_dots(bi, r)
        else:
            src, blks = _block_source(ctxg), None
            if cache is not None and src is not None:
                # one copy of the blocks a shape, shared by the context's plans
                blks = cache.buffer(src.shape, rhs.dtype, src.device)
                refill = lambda: blks.copy_(src)
            precond = _block_precond(ctxg, rhs.dtype, blks)
    elif pc_mode in ("line", "line2"):
        precond = _line_precond(fes, ctxg, pc_mode)
    if tg_corr is not None:
        base = precond if precond is not None else (lambda r: r)
        precond = lambda r: base(r) + tg_corr(r)
    plan = CGPlan(solver, blocks, matvec, sdi, precond, precond_dots, CGGraph(), refill)
    if cache is not None:
        cache.plans[key] = plan
    return plan


def group_solve(fes: FESpace, ctxg: Dict, opts: SolveOptions, rhs, x0, tol=None) -> KrylovResult:
    """Solve S_g phi_g = rhs by PCG on the symmetrically Jacobi-equilibrated system
    D^-1/2 S D^-1/2 y = D^-1/2 rhs with D = exact diag(S): every Krylov
    intermediate is O(1), which float32 needs with the 1e15 void absorbers of
    the IAEA-3D filler.  The preconditioner of that system follows
    ``opts.inner_precond`` (``resolve_precond``): none ("jacobi"), the per-cell
    P x P block-Jacobi inverse ("block"), the line solves ("line", "line2") or
    the fine part plus the additive coarse correction ("twogrid"; the fine part
    alone when no coarse level is attached).  The JAX package's branch order
    (``neutfem_tpu/power.py:206-365``): the equilibration-folded matvec where
    ``eqfold_available``; ``pcg_fused`` under ``NEUTFEM_CGCG=1``; with
    ``pcg`` on one group's float32 flux and no coarse correction, the block
    preconditioner as the fused K8 apply + dots: on the fp8 E-form
    (``precond_blk_dev``, the float32 default) always, on a
    ``precond_blk_inv`` context (float32 or bf16 blocks) under
    ``NEUTFEM_BLOCKJAC=1``.  ``tol`` (0-d tensor) overrides
    ``opts.inner_tol``.  ``inner_solver="direct"`` instead runs the two triangular solves of the dense equilibrated Cholesky factors
    (``ops/direct.py``; one "iteration", residual 0, as in the JAX package).

    ``ctxg`` is one group's context (``ctx_group``), or the whole context for
    the Jacobi sweep's batched solve of every group at once, ``rhs`` and
    ``x0`` then (ng, P, nz, ny, nx): the CG's dot products run over all
    groups, as the JAX ``pcg`` reduces over the whole array.  On the card the
    CG replays the plan's captured graph (``group_plan``, ``krylov``)."""
    if opts.inner_solver == "direct":
        return KrylovResult(x=direct_solve(ctxg, rhs), iterations=1,
                            residual=torch.zeros((), dtype=rhs.dtype, device=rhs.device))
    if opts.inner_solver != "cg":
        raise NotImplementedError(f"inner_solver={opts.inner_solver!r} is not ported")
    plan = group_plan(fes, ctxg, opts, rhs)
    if plan.refill is not None:
        plan.refill()
    res = plan.solver(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                      tol=opts.inner_tol if tol is None else tol, maxiter=opts.max_inner,
                      graph=plan.graph, **plan.kwargs())
    return res._replace(x=res.x * plan.sdi)


def _fission_source(ctx, phi, adjoint: bool = False):
    """Direct: total_fiss = sum_g (nuSigf_g-weighted mass) phi_g (NeutFEM.cpp:1700-1707).
    Adjoint: total_chi = sum_g (chi_g-weighted mass) phi_adj_g (NeutFEM.cpp:1919-1924).
    phi internal (ng, P, sp); returns (P, sp)."""
    w = (ctx["chi"] if adjoint else ctx["nsf"]) * ctx["detJ"]  # (ng, nz, ny, nx)
    return torch.sum(w.unsqueeze(-4) * (ctx["w_mode_col"] * phi), dim=0)


def _production(ctx, phi, adjoint: bool = False):
    """Reference 'production' functional: total of F phi (F^T phi_adj)."""
    if adjoint:
        # sum_g sum_dofs nuSigf_g * total_chi  (NeutFEM.cpp:1929-1932, 1963-1966)
        return torch.sum(torch.sum(ctx["nsf"], dim=0) * _fission_source(ctx, phi, True))
    w = ctx["nsf"] * ctx["detJ"]
    return torch.sum(w.unsqueeze(-4) * (ctx["w_mode_col"] * phi))


def _scatter_into(ctx, g: int, phi, adjoint: bool = False):
    """Direct: sum_{g' != g} (SigS[g<-g']-weighted mass) phi_g' (NeutFEM.cpp:1719-1726).
    Adjoint: the transposed coupling SigS[g'<-g] (NeutFEM.cpp:1944-1950)."""
    out = 0.0
    for gp in range(phi.shape[0]):
        if gp == g:
            continue
        sig = ctx["sigs"][gp, g] if adjoint else ctx["sigs"][g, gp]
        w = sig * ctx["detJ"]  # (nz, ny, nx): broadcasts against (P, sp)
        out = out + w * (ctx["w_mode_col"] * phi[gp])
    return out


def _scatter_all(ctx, phi, adjoint: bool = False):
    """The off-diagonal scattering source of every group at once, (ng, P, sp)."""
    return torch.stack([torch.as_tensor(_scatter_into(ctx, g, phi, adjoint), dtype=phi.dtype,
                                        device=phi.device).expand(phi.shape[1:])
                        for g in range(phi.shape[0])])


def _external_source(ctx, g: int):
    """Flux-space rhs of the per-element-constant external source Q_g: only
    the P_0 mode is excited, with weight detJ * w_mode[0].  (The JAX
    package's boundary source ``src_bc`` of a nonzero NEUMANN boundary is not
    ported: ``build_context`` refuses such a boundary.)"""
    wm = ctx["w_mode_col"]  # (P, 1, 1, 1)
    onehot = torch.zeros_like(wm)
    onehot[0] = wm[0]
    return (ctx["src"][g] * ctx["detJ"]) * onehot  # (P, nz, ny, nx)


def compute_current(fes: FESpace, ctx: Dict, phi, a_mode: str = "exact"):
    """J = A^{-1} B^T phi for all groups (internal layout), one batched Thomas
    solve per direction; with bubbles (k >= 1) also their DOFs ("bub")."""
    J = {}
    for di in fes.dirs:
        key = f"d{di.d}"
        rF, rW = apply_BT_dir(fes, di, phi)
        F, W = solve_A_dir(fes, di, ctx[f"tri_dinv_{key}"], ctx[f"tri_l_{key}"],
                           ctx[f"mask_{key}"], ctx[f"alpha_{key}"], rF, rW, a_mode)
        J[key] = {"face": F} if W is None else {"face": F, "bub": W}
    return J


def power_iteration(fes: FESpace, ng: int, opts: SolveOptions, ctx: Dict, phi0, keff0,
                    adjoint: bool = False, fixed_keff=None):
    """Run the accelerated power iteration.  Returns a result dict.

    phi0: (ng, nz, ny, nx, P) initial flux (public layout, on the context's
    device); keff0: initial eigenvalue.  adjoint: solve the adjoint problem
    (transposed chi / nuSigf / SigS couplings, groups swept in reverse; A and
    C are symmetric, so the same Schur solve serves).  fixed_keff: if given,
    the eigenvalue is held at keff0 (the reference's use_direct_keff) and
    convergence is on the flux only."""
    if opts.accel not in ("chebyshev", "anderson", "none"):
        raise ValueError(f"unknown accel {opts.accel!r}")
    if opts.sweep not in ("gs", "jacobi"):
        raise NotImplementedError(f"sweep={opts.sweep!r} is not ported")
    use_cmfd = opts.use_cmfd and not adjoint
    if use_cmfd and opts.cmfd_mode != "fixed":
        raise NotImplementedError(f"cmfd_mode={opts.cmfd_mode!r} is not ported "
                                  "(it needs bicgstab)")

    phi = phi_to_internal(phi0)
    dtype, device = phi.dtype, phi.device
    if device.type == "cuda":
        ctx.setdefault(CG_PLANS, CGPlans())  # the group solves' captured CGs

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    # Chebyshev runs only without CMFD (NeutFEM.cpp:1786-1788) and not under the
    # Jacobi sweep, whose subdominant spectrum is not confined to the real
    # interval Chebyshev assumes (the JAX package's rule)
    use_cheby = opts.accel == "chebyshev" and not opts.use_cmfd and opts.sweep != "jacobi"
    # Anderson also runs under the Jacobi sweep (and in the adjoint, and at a
    # fixed eigenvalue), from outer 2 on
    use_anderson = opts.accel == "anderson" and not opts.use_cmfd
    cheby_from = 5 if adjoint else 2  # reference NeutFEM.cpp:1786 vs :1990
    cheb = chebyshev_init(phi)
    ands = anderson_init(phi.numel(), opts.anderson_m, dtype, device) if use_anderson else None
    rhs_w = ctx["nsf"] if adjoint else ctx["chi"]  # group-row weight of the fission rhs
    # Adjoint sweeps groups in REVERSE: importance flows up the group ladder
    # (the reference sweeps forward, NeutFEM.cpp:1936; with a forward adjoint
    # sweep the Chebyshev extrapolation destabilizes — the JAX package's
    # documented deviation)
    sweep_order = range(ng - 1, -1, -1) if adjoint else range(ng)
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

        total_fiss = _fission_source(ctx, phi, adjoint)
        prod_old = _production(ctx, phi, adjoint) if adjoint else torch.sum(total_fiss)

        inner_iters = 0
        if opts.sweep == "jacobi":
            # all groups at once: scattering from the OLD fluxes, one batched
            # CG over the leading group axis (the context carries ng in front)
            rhs = rhs_w.unsqueeze(-4) * total_fiss / keff + _scatter_all(ctx, phi, adjoint)
            res = group_solve(fes, ctx, opts, rhs,
                              phi if opts.warm_start else torch.zeros_like(phi), tol=tol_g)
            phi = res.x
            inner_iters = last_inner = res.iterations
            last_resid = res.residual
        else:
            phi = phi.clone()
            for g in sweep_order:
                ctxg = ctx_group(ctx, g)
                # chi (nuSigf in adjoint mode) is constant per element, so it
                # multiplies every mode of the (mass-weighted) fission source
                rhs = rhs_w[g] * total_fiss / keff
                rhs = rhs + _scatter_into(ctx, g, phi, adjoint)
                x0 = phi[g] if opts.warm_start else torch.zeros_like(phi[g])
                res = group_solve(fes, ctxg, opts, rhs, x0, tol=tol_g)
                phi[g] = res.x
                inner_iters += res.iterations
                last_inner = res.iterations
                last_resid = res.residual

        cmfd_active = use_cmfd and it >= opts.cmfd_from_iter
        if cmfd_active:
            # CMFD correction BEFORE the k-update (reference ordering,
            # NeutFEM.cpp:1750-1761); the JAX lax.cond on the count is this if
            J = compute_current(fes, ctx, phi, a_mode=opts.a_mode)
            ratio, k_lo = cmfd_correction(fes, ctx, phi, J, keff, omega=opts.cmfd_omega,
                                          mode=opts.cmfd_mode)
            phi = phi * ratio.unsqueeze(-4)

        prod_new = _production(ctx, phi, adjoint)
        safe_old = torch.where(prod_old == 0, 1.0, prod_old)
        keff_new = keff * prod_new / safe_old
        if cmfd_active and opts.cmfd_use_lo_k:
            keff_new = k_lo
        diff_k = torch.abs(keff_new - keff)
        if fixed_keff is not None:
            diff_k = torch.zeros_like(diff_k)
        elif it >= 1:
            keff = keff_new

        sol_norm_sq = torch.sum(phi * phi)
        diff_norm_sq = torch.sum((phi - phi_old) ** 2)
        diff_flux = torch.sqrt(diff_norm_sq / torch.where(sol_norm_sq == 0, 1.0, sol_norm_sq))
        norm = torch.sqrt(sol_norm_sq)
        phi = phi / torch.where(norm > 1e-14, norm, 1.0)

        if use_cheby:
            cheb, phi = chebyshev_apply_blend(cheb, phi, it >= cheby_from,
                                              opts.cheby_nmax, opts.cheby_sigma)
        elif use_anderson and it >= 2:
            # x_prev: the iterate before the group solves; g(x): the
            # normalised new flux (both internal layout, flattened)
            ands, acc = anderson_apply(ands, phi_old, phi)
            phi = acc.reshape(phi.shape)
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


def biorthogonal_inner(ctx, phi, phi_adj):
    """<phi, phi_adj>_M with the Legendre mass weights (NeutFEM.cpp:2020-2066):
    sum_g sum_{e,p} phi phi_adj detJ_e w_mode_p, on public (ng, nz, ny, nx, P)
    fluxes."""
    return torch.sum(phi * phi_adj * ctx["detJ"][..., None] * ctx["w_mode"])


def fixed_source_solve(fes: FESpace, ng: int, opts: SolveOptions, ctx: Dict, phi0,
                       with_fission: bool = True, keff: float = 1.0):
    """Fixed-source (subcritical) solve: H phi = (1/keff) F phi + Q, the
    fission source iterated at fixed k until the flux stagnates (the JAX
    package's ``fixed_source_solve``); the external source Q (``ctx["src"]``,
    per element) drives the P_0 mode.  With ``with_fission=False`` a pure
    source problem, still iterated to converge upscatter through the
    Gauss-Seidel sweep.  One host read per outer (the stop test), as in
    ``power_iteration``; the adaptive inner tolerance and its endgame guard
    are the same."""
    phi = phi_to_internal(phi0)
    dtype, device = phi.dtype, phi.device
    if device.type == "cuda":
        ctx.setdefault(CG_PLANS, CGPlans())
    # the adaptive schedule's endgame floor, as in power_iteration: only an
    # outer solved at inner_tol accuracy certifies convergence
    endgame_tol = max(opts.inner_tol, 0.1 * opts.tol_flux) * 1.0001
    diff = torch.tensor(1.0, dtype=dtype, device=device)
    tol_used = diff
    it, inner_tot = 0, 0

    def not_converged() -> bool:
        nc = diff >= opts.tol_flux
        if opts.inner_eta > 0:
            nc = nc | (tol_used > endgame_tol)
        return bool(nc)  # the one host sync per outer iteration

    while it < opts.max_outer and not_converged():
        phi_old = phi
        total_fiss = _fission_source(ctx, phi) if with_fission else 0.0
        tol_g = None
        tol_used = torch.tensor(opts.inner_tol, dtype=dtype, device=device)
        if opts.inner_eta > 0:
            tol_g = torch.clamp(opts.inner_eta * diff, opts.inner_tol, 0.1)
            tol_used = tol_g
        phi = phi.clone()
        for g in range(ng):
            rhs = _external_source(ctx, g)
            if with_fission:
                rhs = rhs + ctx["chi"][g] * total_fiss / keff
            rhs = rhs + _scatter_into(ctx, g, phi)
            x0 = phi[g] if opts.warm_start else torch.zeros_like(phi[g])
            res = group_solve(fes, ctx_group(ctx, g), opts, rhs, x0, tol=tol_g)
            phi[g] = res.x
            inner_tot += res.iterations
        num = torch.sum((phi - phi_old) ** 2)
        den = torch.sum(phi * phi)
        diff = torch.sqrt(num / torch.where(den == 0, 1.0, den))
        it += 1

    J = compute_current(fes, ctx, phi, a_mode=opts.a_mode)
    return {
        "phi": phi_to_public(phi),
        "J": J_to_public(J),
        "outer_iterations": it,
        "inner_iterations": inner_tot,
        "diff_flux": diff,
        "finite": torch.all(torch.isfinite(phi)),
    }


def solve_subcritical(fes: FESpace, ng: int, opts: SolveOptions, ctx: Dict, phi0,
                      keff: float = 1.0):
    """Subcritical amplification M = ||phi with fission|| / ||phi without
    fission|| (wrapper.cpp:708).  The result is the with-fission solve's,
    plus ``amplification``, ``phi_no_fission`` and the source-only solve's
    ``outer_iterations_no_fission``."""
    res_f = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=True, keff=keff)
    res_0 = fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=False)
    n_f = torch.sqrt(torch.sum(res_f["phi"] ** 2))
    n_0 = torch.sqrt(torch.sum(res_0["phi"] ** 2))
    return {**res_f, "amplification": n_f / torch.where(n_0 == 0, 1.0, n_0),
            "phi_no_fission": res_0["phi"],
            "outer_iterations_no_fission": res_0["outer_iterations"]}
