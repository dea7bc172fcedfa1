"""Conjugate gradient (port of ``neutfem_tpu/krylov.py`` ``pcg``).

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here it
is a Python loop: the vectors stay on the device and the stop test is fetched
once per iteration (one host sync), so the iteration count is exact — it is a
parity observable.  Stopping rule of the reference: ``||r||^2 < tol^2 ||b||^2``
(solvers.cpp:592, 620).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "KrylovResult"]


def _dot(a, b):
    return torch.sum(a * b)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # ||r|| / ||b||


def pcg(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
        maxiter: int = 1000) -> KrylovResult:
    """Preconditioned CG on an SPD operator (the JAX ``pcg``, textbook loop).

    With ``precond=None`` the identity preconditioner is specialized away: no z
    vector and no separate <r, z> reduction (rz == rr) — the solver's Jacobi
    preconditioning is the symmetric equilibration done by
    ``power.group_solve``.  Otherwise z = precond(r), rz = <r, z> and
    beta = rz_new / rz.

    ``tol`` may be a float or a 0-d tensor of rhs's dtype (the adaptive inner
    tolerance)."""
    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    # b = 0 has the solution x = 0, but a nonzero warm start would make the
    # relative stopping rule unreachable: guard as the JAX package does.
    zero_rhs = bool(b_norm_sq == 0.0)

    x = x0
    r = rhs - matvec(x0)
    rr = _dot(r, r)
    if precond is None:
        z, rz = r, rr
    else:
        z = precond(r)
        rz = _dot(r, z)
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
            rr_new = _dot(r, r)
            if precond is None:
                z, rz_new = r, rr_new
            else:
                z = precond(r)
                rz_new = _dot(r, z)
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
