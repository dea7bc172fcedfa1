"""Conjugate gradient (port of ``neutfem_tpu/krylov.py`` ``pcg`` and ``pcg_fused``).

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here it
is a Python loop: the vectors stay on the device and the stop test is fetched
once per iteration (one host sync), so the iteration count is exact — it is a
parity observable.  Stopping rule of the reference: ``||r||^2 < tol^2 ||b||^2``
(solvers.cpp:592, 620).

* ``pcg``: the textbook loop; ``precond_dots`` takes a fused preconditioner
  ``r -> (z, <r, z>, <r, r>)`` (the K8 block-Jacobi kernel, ``ops/blockjac.py``).
* ``pcg_fused``: the Chronopoulos-Gear single-reduction recurrence, selected by
  ``power.group_solve`` under ``NEUTFEM_CGCG=1`` (opt-in, as in the JAX
  package).  Its dot products are separate ``torch.sum`` reductions here: the
  port has no fused multi-result reduction, so it keeps the recurrence and
  the iteration counts, not the JAX package's one-reduction kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "pcg_fused", "KrylovResult"]


def _dot(a, b):
    return torch.sum(a * b)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # ||r|| / ||b||


def pcg(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
        maxiter: int = 1000, precond_dots: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned CG on an SPD operator (the JAX ``pcg``, textbook loop).

    With ``precond=None`` the identity preconditioner is specialized away: no z
    vector and no separate <r, z> reduction (rz == rr) — the solver's Jacobi
    preconditioning is the symmetric equilibration done by
    ``power.group_solve``.  Otherwise z = precond(r), rz = <r, z> and
    beta = rz_new / rz.  ``precond_dots`` (overrides ``precond``) returns
    (z, rz, rr) from r in one call.

    ``tol`` may be a float or a 0-d tensor of rhs's dtype (the adaptive inner
    tolerance)."""
    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    # b = 0 has the solution x = 0, but a nonzero warm start would make the
    # relative stopping rule unreachable: guard as the JAX package does.
    zero_rhs = bool(b_norm_sq == 0.0)

    x = x0
    r = rhs - matvec(x0)

    def apply(r):  # (z, <r, z>, <r, r>)
        if precond_dots is not None:
            return precond_dots(r)
        rr = _dot(r, r)
        if precond is None:
            return r, rr, rr
        z = precond(r)
        return z, _dot(r, z), rr

    z, rz, rr = apply(r)
    p = z
    tiny = torch.finfo(rr.dtype).tiny

    it = 0
    if not zero_rhs:
        go = bool(rr > tol_sq)
        while go and it < maxiter:
            q = matvec(p)
            pq = _dot(p, q)
            breakdown = torch.abs(pq) <= tiny
            alpha = torch.where(breakdown, 0.0, rz / torch.where(breakdown, 1.0, pq))
            x = x + alpha * p
            r = r - alpha * q
            z, rz_new, rr_new = apply(r)
            beta = rz_new / torch.where(rz == 0.0, 1.0, rz)
            p = z + beta * p
            rr, rz = rr_new, rz_new
            it += 1
            go = bool((rr > tol_sq) & ~breakdown)  # the one host sync per iteration

    if zero_rhs:
        x = torch.zeros_like(x)
        rr = torch.zeros_like(rr)
    denom = torch.sqrt(torch.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=torch.sqrt(rr) / denom)


def pcg_fused(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
              maxiter: int = 1000) -> KrylovResult:
    """Chronopoulos-Gear PCG (the JAX ``pcg_fused``): with u = M r, w = A u,

        p <- u + beta p;  s <- w + beta s;  x <- x + alpha p;  r <- r - alpha s
        gamma' = <r, u>;  delta = <w, u>  [rr = <r, r> when M != I]
        beta = gamma' / gamma;  alpha = gamma' / (delta - beta gamma' / alpha)

    Same fixed point and stopping rule as ``pcg``; the residual is
    sqrt(|rr|) / ||b||."""
    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = bool(b_norm_sq == 0.0)  # see pcg

    def dots(r, u, w):  # (gamma, delta, rr)
        gamma = _dot(r, u)
        return gamma, _dot(w, u), (gamma if precond is None else _dot(r, r))

    x = x0
    r = rhs - matvec(x0)
    u = r if precond is None else precond(r)
    w = matvec(u)
    gamma, delta, rr = dots(r, u, w)
    tiny = torch.finfo(rr.dtype).tiny
    breakdown = torch.abs(delta) <= tiny
    alpha = torch.where(breakdown, 0.0, gamma / torch.where(breakdown, 1.0, delta))
    beta = torch.zeros_like(gamma)
    p = torch.zeros_like(r)
    s = torch.zeros_like(r)

    it = 0
    if not zero_rhs:
        go = bool((rr > tol_sq) & ~breakdown)
        while go and it < maxiter:
            p = u + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            u = r if precond is None else precond(r)
            w = matvec(u)
            gamma_new, delta, rr = dots(r, u, w)
            beta = gamma_new / torch.where(gamma == 0.0, 1.0, gamma)
            denom = delta - beta * gamma_new / alpha
            breakdown = torch.abs(denom) <= tiny
            alpha = torch.where(breakdown, 0.0, gamma_new / torch.where(breakdown, 1.0, denom))
            gamma = gamma_new
            it += 1
            go = bool((rr > tol_sq) & ~breakdown)  # the one host sync per iteration

    if zero_rhs:
        x = torch.zeros_like(x)
        rr = torch.zeros_like(rr)
    denom = torch.sqrt(torch.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=torch.sqrt(torch.abs(rr)) / denom)
