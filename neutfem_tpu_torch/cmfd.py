"""Coarse-mesh finite-difference (CMFD) nonlinear acceleration (port of
``neutfem_tpu/cmfd.py``).

Rebuild of the reference CMFD (NeutFEM.cpp:662-1017) with the JAX package's two
documented improvements: D-hat on every active direction (the reference has X
faces only) and the scattering source in the low-order rhs.  With both, the
fine mixed-FEM solution is an exact fixed point of the CMFD system.

* Dtilde per face (``ops.context.build_context``): interior
  ``2 D_L D_R / (D_L h_R + D_R h_L)``, boundary ``2D/h`` (NeutFEM.cpp:714-809).
* Dhat = J_face / (phi_L - phi_R) - Dtilde, zeroed only where the face's flux
  difference is negligible against the fluxes themselves, with phi = 0 outside
  the domain (NeutFEM.cpp:836-860) — on a PERIODIC direction the neighbour
  across the seam is the cell at the other end (``_neighbor_pad``).
* Low-order 7-point operator: diag ``Sigr V + sum_f (Dtilde+Dhat) A_f``,
  off-diagonal ``-(Dtilde+Dhat) A_f`` (NeutFEM.cpp:897-975); mode "fixed" (the
  facade's) solves it once at the current k by CG with its diagonal as
  preconditioner (tol 1e-8, 100 iterations); mode "wielandt" (experimental in
  the JAX package) converges the low-order eigenproblem by Wielandt-shifted
  inverse iteration, one BiCGSTAB solve of the |diag|^-1/2-equilibrated
  shifted operator per low-order outer, with the JAX package's NaN net and
  its trust region on the low-order k.
* Correction: elementwise ratio clipped to [0.5, 2.0], relaxed by omega,
  applied to every local mode of the element (NeutFEM.cpp:994-1016).

On the card each low-order solve replays a captured graph (``krylov``) whose
operator reads static buffers made once per context and refilled per call.

Under a sharding scope (one rank's slab, ``parallel.py``) the stencils pad
along a cut with the neighbour ranks' planes (``shardctx.halo``, round the
ring on a PERIODIC cut direction; under NCCL the low-order graph captures
those sends), the face arrays that
``parallel.shard_context`` split into body and seam are joined into the
slab's s+1 faces (``shardctx.seam_faces``; the current's faces come from
``power.compute_current`` as s+1 already), and every sum that decides a
branch or a stop test is all-reduced (the CG's and BiCGSTAB's dots in
``krylov``, mode "wielandt"'s norms and productions here).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import tracing
from .fespace import FESpace
from .krylov import CG_PLANS, CGGraph, bicgstab, pcg
from .shardctx import all_ranks, allsum, cut_transport, halo, seam_faces

__all__ = ["cmfd_correction"]


def _faces(ctx: Dict, name: str, di, ax: int):
    """The face array ``name`` of direction ``di`` with every face of the
    rank's cells along tensor axis ``ax``: the context's own, or along a cut
    (where ``parallel.shard_context`` split it into body and seam) its slab's
    s+1 faces (``shardctx.seam_faces``)."""
    tr = cut_transport(di.axis)
    if tr is None:
        return ctx[name]
    return seam_faces(ctx[name], ctx[name + "__seam"], ax, tr)


def _face_currents(fes: FESpace, ctx: Dict, J) -> Dict[str, torch.Tensor]:
    """Physical cell-average normal current density per face and direction (all
    groups): the t=0 transverse mode of the face DOF grid times the Piola scale
    jac_d/detJ.  J internal: (ng, T, *face_shape)."""
    return {f"d{di.d}": J[f"d{di.d}"]["face"].select(-4, 0)
            * _faces(ctx, f"jscale_d{di.d}", di, di.axis) for di in fes.dirs}


def _neighbor_pad(ctx: Dict, di, x, ax: int):
    """x with its out-of-domain neighbours along ``ax`` (direction ``di``'s
    axis) on each side: zeros on a bounded direction, the cells of the other
    end on a PERIODIC one (its ``cyc_*`` data in the context); along a cut,
    the neighbour ranks' planes (``shardctx.halo``: zeros at the domain's
    ends, or on a PERIODIC direction the planes of the ranks at the other
    end, round the ring)."""
    key = f"d{di.d}"
    n = x.shape[ax]
    periodic = f"cyc_wt_{key}" in ctx
    tr = cut_transport(di.axis)
    if tr is not None:
        lo, hi = halo(x, ax, tr, cyclic=periodic)
        return torch.cat([lo, x, hi], dim=ax)
    if periodic:
        return torch.cat([x.narrow(ax, n - 1, 1), x, x.narrow(ax, 0, 1)], dim=ax)
    shape = list(x.shape)
    shape[ax] = 1
    z = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([z, x, z], dim=ax)


def _deff(fes: FESpace, ctx: Dict, phi_bar, j_phys) -> Dict[str, torch.Tensor]:
    """Dtilde + Dhat per face per group.  phi_bar: (ng, nz, ny, nx) cell averages."""
    out = {}
    for di in fes.dirs:
        key = f"d{di.d}"
        ax = di.axis + 1  # group axis in front
        padded = _neighbor_pad(ctx, di, phi_bar, ax)
        n = padded.shape[ax]
        left, right = padded.narrow(ax, 0, n - 1), padded.narrow(ax, 1, n - 1)
        dphi = left - right  # phi_L - phi_R at every face
        dtilde = _faces(ctx, f"dtilde_{key}", di, ax)
        # RELATIVE degeneracy guard (the JAX package's: an absolute clamp biases
        # the fixed point by +52 pcm on IAEA-2D)
        small = torch.abs(dphi) <= 1e-12 * (torch.abs(left) + torch.abs(right)) + 1e-300
        dhat = torch.where(small, 0.0, j_phys[key] / torch.where(small, 1.0, dphi) - dtilde)
        out[key] = dtilde + dhat
    return out


def _lo_matvec(fes: FESpace, ctx: Dict, deff: Dict, x):
    """Low-order CMFD operator on (ng, nz, ny, nx) cell grids (all groups batched)."""
    out = ctx["sigr"] * ctx["vol"] * x
    for di in fes.dirs:
        key = f"d{di.d}"
        ax = di.axis + 1
        xp = _neighbor_pad(ctx, di, x, ax)
        n = xp.shape[ax]
        nf = deff[key].shape[ax]
        d_left = deff[key].narrow(ax, 0, nf - 1)
        d_right = deff[key].narrow(ax, 1, nf - 1)
        out = out + ctx[f"area_{key}"] * (d_left * (x - xp.narrow(ax, 0, n - 2))
                                          + d_right * (x - xp.narrow(ax, 2, n - 2)))
    return out


def _lo_sources(ctx, phi_bar, keff):
    """chi_g/k * total fission + in-scatter, volume-weighted (lo-system rhs)."""
    return _fission_lo(ctx, phi_bar) / keff + _scatter_lo(ctx, phi_bar)


def _lo_operator(fes: FESpace, ctx: Dict, deff: Dict, diag_fix):
    """(matvec, precond, graph) of the low-order CG.  On the card, with the
    context's ``krylov.CGPlans``, the operator and its diagonal live in static
    buffers made once per context (refilled from ``deff`` and ``diag_fix``
    at every call) and the CG replays one graph; otherwise they close over
    the call's tensors and the graph is the CG's own (None)."""
    plans = ctx.get(CG_PLANS) if diag_fix.device.type == "cuda" else None
    if plans is None:
        return (lambda v: _lo_matvec(fes, ctx, deff, v), lambda r: r / diag_fix, None)
    key = ("cmfd", tuple(diag_fix.shape), diag_fix.dtype)
    if key not in plans.plans:
        base = {k: v for k, v in ctx.items() if k != CG_PLANS}
        sdeff = {k: torch.empty_like(v) for k, v in deff.items()}
        sdiag = torch.empty_like(diag_fix)
        plans.plans[key] = (lambda v: _lo_matvec(fes, base, sdeff, v), lambda r: r / sdiag,
                            CGGraph(), sdeff, sdiag)
    matvec, precond, graph, sdeff, sdiag = plans.plans[key]
    for k, v in deff.items():
        sdeff[k].copy_(v)
    sdiag.copy_(diag_fix)
    return matvec, precond, graph


def _scatter_lo(ctx, p):
    """The volume-weighted in-scatter sum_{h != g} SigS[g<-h] p_h V."""
    sigs = ctx["sigs"]
    return (torch.einsum("gh...,h...->g...", sigs, p)
            - torch.diagonal(sigs, dim1=0, dim2=1).movedim(-1, 0) * p) * ctx["vol"]


def _fission_lo(ctx, p):
    """chi_g (sum_h nuSigf_h p_h) V."""
    return ctx["chi"] * (torch.sum(ctx["nsf"] * p, dim=0) * ctx["vol"])[None]


def _wielandt_operator(fes: FESpace, ctx: Dict, deff: Dict, sdi, inv_ks):
    """(matvec, graph) of the Wielandt low-order BiCGSTAB: the equilibrated
    shifted operator sdi (L - S - inv_ks F) sdi.  On the card, with the
    context's ``krylov.CGPlans``, its operands live in static buffers made
    once per context and refilled here, and the solves replay one graph."""
    def op(deff_, sdi_, inv_ks_):
        def matvec(v):
            w = sdi_ * v
            return sdi_ * (_lo_matvec(fes, ctx, deff_, w) - _scatter_lo(ctx, w)
                           - inv_ks_ * _fission_lo(ctx, w))
        return matvec

    plans = ctx.get(CG_PLANS) if sdi.device.type == "cuda" else None
    if plans is None:
        return op(deff, sdi, inv_ks), None
    key = ("cmfd_wielandt", tuple(sdi.shape), sdi.dtype)
    if key not in plans.plans:
        sdeff = {k: torch.empty_like(v) for k, v in deff.items()}
        ssdi, sinv = torch.empty_like(sdi), torch.empty_like(inv_ks)
        plans.plans[key] = (op(sdeff, ssdi, sinv), CGGraph(), sdeff, ssdi, sinv)
    matvec, graph, sdeff, ssdi, sinv = plans.plans[key]
    for k, v in deff.items():
        sdeff[k].copy_(v)
    ssdi.copy_(sdi)
    sinv.copy_(inv_ks)
    return matvec, graph


def _wielandt(fes: FESpace, ctx: Dict, phi_bar, deff, diag_lo, keff, tol, maxiter,
              lo_outers: int, lo_tol: float):
    """The low-order eigensolve of mode "wielandt" (``neutfem_tpu/cmfd.py:
    216-263``): (phi_lo, k_lo), k_lo in the trust region [0.8 k, 1.25 k].
    One host read per low-order outer (its stop test)."""
    norm0 = torch.sqrt(allsum(torch.sum(phi_bar * phi_bar)))
    inv_ks = torch.clamp(1.0 / keff - 0.03, min=0.0)  # the reactivity gap 1/k - 1/ks
    diag_w = diag_lo - inv_ks * ctx["chi"] * ctx["nsf"] * ctx["vol"]
    diag_w = torch.where(torch.abs(diag_w) < 1e-30, 1.0, diag_w)
    # the symmetric |diag|^-1/2 equilibration keeps every BiCGSTAB
    # intermediate O(1) (float32 with the 1e15 void absorbers)
    sdi = 1.0 / torch.sqrt(torch.abs(diag_w))
    matvec, graph = _wielandt_operator(fes, ctx, deff, sdi, inv_ks)
    p, inv_k = phi_bar, 1.0 / keff
    for _ in range(lo_outers):
        Fp = _fission_lo(ctx, p)
        prod_old = allsum(torch.sum(Fp))
        res = bicgstab(matvec, sdi * ((inv_k - inv_ks) * Fp), p / sdi, tol=tol, maxiter=maxiter,
                       graph=graph)
        p_new = sdi * res.x
        prod_new = allsum(torch.sum(_fission_lo(ctx, p_new)))
        inv_k_new = inv_ks + (inv_k - inv_ks) * prod_old / torch.where(prod_new == 0, 1.0,
                                                                      prod_new)
        nrm = torch.sqrt(allsum(torch.sum(p_new * p_new)))
        p_new = p_new * (norm0 / torch.where(nrm == 0, 1.0, nrm))
        # the NaN net: a broken-down lo solve must not poison the fine iteration
        ok = all_ranks(torch.isfinite(p_new).all()) & torch.isfinite(inv_k_new)
        p_new = torch.where(ok, p_new, p)
        inv_k_new = torch.where(ok, inv_k_new, inv_k)
        dk = torch.where(ok, torch.abs(1.0 / inv_k_new - 1.0 / inv_k), 0.0)
        p, inv_k = p_new, inv_k_new
        with tracing.sync("stop_test"):
            go = bool(dk >= lo_tol)  # the one host read of a low-order outer
        if not go:
            break
    # trust region: the lo eigenvalue is exact at the fixed point but can be
    # junk in the first corrected iterations (Dhat built from an unconverged J)
    return p, torch.clamp(1.0 / inv_k, 0.8 * keff, 1.25 * keff)


def cmfd_correction(fes: FESpace, ctx: Dict, phi, J, keff, omega: float = 1.0,
                    tol: float = 1e-8, maxiter: int = 100, lo_outers: int = 60,
                    lo_tol: float = 1e-7, mode: str = "fixed"):
    """One CMFD correction step at the current (phi, J, keff); returns
    (correction ratio (ng, nz, ny, nx), k_lo) — k_lo is keff in mode "fixed",
    the low-order eigenvalue in mode "wielandt".

    phi: (ng, P, nz, ny, nx) fine flux (internal mode-first layout) after the
    group sweep; J: current dict (internal layout)."""
    if mode not in ("fixed", "wielandt"):
        raise ValueError(f"unknown CMFD mode {mode!r}")
    # P_0 mode = cell average (Legendre normalization); mode axis at -4
    phi_bar = phi.select(-4, 0)
    deff = _deff(fes, ctx, phi_bar, _face_currents(fes, ctx, J))

    # Jacobi diagonal of the lo operator: removal + leakage
    diag_lo = ctx["sigr"] * ctx["vol"]
    for di in fes.dirs:
        key = f"d{di.d}"
        ax = di.axis + 1
        nf = deff[key].shape[ax]
        diag_lo = diag_lo + ctx[f"area_{key}"] * (deff[key].narrow(ax, 0, nf - 1)
                                                  + deff[key].narrow(ax, 1, nf - 1))
    if mode == "fixed":
        diag_fix = torch.where(torch.abs(diag_lo) < 1e-30, 1.0, diag_lo)
        matvec, precond, graph = _lo_operator(fes, ctx, deff, diag_fix)
        phi_lo = pcg(matvec, _lo_sources(ctx, phi_bar, keff), phi_bar, precond=precond, tol=tol,
                     maxiter=maxiter, graph=graph).x
        k_lo = keff
    else:
        phi_lo, k_lo = _wielandt(fes, ctx, phi_bar, deff, diag_lo, keff, tol, maxiter,
                                 lo_outers, lo_tol)
    safe = torch.abs(phi_bar) > 1e-14
    ratio = torch.where(safe, phi_lo / torch.where(safe, phi_bar, 1.0), 1.0)
    ratio = torch.clamp(ratio, 0.5, 2.0)
    ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
    return omega * ratio + (1.0 - omega), k_lo
