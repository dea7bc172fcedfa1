"""Coarse-mesh finite-difference (CMFD) nonlinear acceleration (port of
``neutfem_tpu/cmfd.py``, mode "fixed").

Rebuild of the reference CMFD (NeutFEM.cpp:662-1017) with the JAX package's two
documented improvements: D-hat on every active direction (the reference has X
faces only) and the scattering source in the low-order rhs.  With both, the
fine mixed-FEM solution is an exact fixed point of the CMFD system.

* Dtilde per face (``ops.context.build_context``): interior
  ``2 D_L D_R / (D_L h_R + D_R h_L)``, boundary ``2D/h`` (NeutFEM.cpp:714-809).
* Dhat = J_face / (phi_L - phi_R) - Dtilde, zeroed only where the face's flux
  difference is negligible against the fluxes themselves, with phi = 0 outside
  the domain (NeutFEM.cpp:836-860).
* Low-order 7-point operator: diag ``Sigr V + sum_f (Dtilde+Dhat) A_f``,
  off-diagonal ``-(Dtilde+Dhat) A_f`` (NeutFEM.cpp:897-975), one fixed-source
  solve at the current k by CG with its diagonal as preconditioner (tol 1e-8,
  100 iterations) — the mode "fixed" the facade uses.
* Correction: elementwise ratio clipped to [0.5, 2.0], relaxed by omega,
  applied to every local mode of the element (NeutFEM.cpp:994-1016).

Mode "wielandt" (the JAX package's experimental lo eigensolve) needs
``bicgstab``, which is not ported: it raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .fespace import FESpace
from .krylov import CG_PLANS, CGGraph, pcg

__all__ = ["cmfd_correction"]


def _face_currents(fes: FESpace, ctx: Dict, J) -> Dict[str, torch.Tensor]:
    """Physical cell-average normal current density per face and direction (all
    groups): the t=0 transverse mode of the face DOF grid times the Piola scale
    jac_d/detJ.  J internal: (ng, T, *face_shape)."""
    return {f"d{di.d}": J[f"d{di.d}"]["face"].select(-4, 0) * ctx[f"jscale_d{di.d}"]
            for di in fes.dirs}


def _zero_pad(x, ax: int):
    """x with one zero slice on each side along ``ax`` (outside the domain)."""
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
        padded = _zero_pad(phi_bar, ax)
        n = padded.shape[ax]
        left, right = padded.narrow(ax, 0, n - 1), padded.narrow(ax, 1, n - 1)
        dphi = left - right  # phi_L - phi_R at every face
        dtilde = ctx[f"dtilde_{key}"]
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
        xp = _zero_pad(x, ax)
        n = xp.shape[ax]
        nf = deff[key].shape[ax]
        d_left = deff[key].narrow(ax, 0, nf - 1)
        d_right = deff[key].narrow(ax, 1, nf - 1)
        out = out + ctx[f"area_{key}"] * (d_left * (x - xp.narrow(ax, 0, n - 2))
                                          + d_right * (x - xp.narrow(ax, 2, n - 2)))
    return out


def _lo_sources(ctx, phi_bar, keff):
    """chi_g/k * total fission + in-scatter, volume-weighted (lo-system rhs)."""
    fiss = torch.sum(ctx["nsf"] * phi_bar, dim=0) * ctx["vol"]  # (nz, ny, nx)
    rhs = ctx["chi"] * fiss[None] / keff
    sigs = ctx["sigs"]
    scat = (torch.einsum("gh...,h...->g...", sigs, phi_bar)
            - torch.diagonal(sigs, dim1=0, dim2=1).movedim(-1, 0) * phi_bar)
    return rhs + scat * ctx["vol"]


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


def cmfd_correction(fes: FESpace, ctx: Dict, phi, J, keff, omega: float = 1.0,
                    tol: float = 1e-8, maxiter: int = 100, mode: str = "fixed"):
    """One CMFD correction step at the current (phi, J, keff); returns
    (correction ratio (ng, nz, ny, nx), k_lo) — k_lo is keff in mode "fixed".

    phi: (ng, P, nz, ny, nx) fine flux (internal mode-first layout) after the
    group sweep; J: current dict (internal layout)."""
    if mode != "fixed":
        raise NotImplementedError(f"CMFD mode {mode!r} is not ported (it needs bicgstab)")
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
    diag_fix = torch.where(torch.abs(diag_lo) < 1e-30, 1.0, diag_lo)
    matvec, precond, graph = _lo_operator(fes, ctx, deff, diag_fix)
    res = pcg(matvec, _lo_sources(ctx, phi_bar, keff), phi_bar, precond=precond, tol=tol,
              maxiter=maxiter, graph=graph)
    safe = torch.abs(phi_bar) > 1e-14
    ratio = torch.where(safe, res.x / torch.where(safe, phi_bar, 1.0), 1.0)
    ratio = torch.clamp(ratio, 0.5, 2.0)
    ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
    return omega * ratio + (1.0 - omega), keff
