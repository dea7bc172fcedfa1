"""Chebyshev and Anderson acceleration of the power iteration (port of
``neutfem_tpu/accel.py``).

Faithful port of the reference recurrence (solvers.cpp:664-756)::

    gamma = acosh(2/sigma - 1)
    a_1   = 2 / (2 - sigma)
    a_n   = cosh((n-1) gamma) / cosh(n gamma),  b_n = cosh((n-2) gamma) / cosh(n gamma)

    n = 0: store phi_0
    n = 1: phi <- phi_0 + a_1 (phi - phi_0)
    n >= 2: phi <- phi_1 + (4/sigma) a_n (phi - phi_1) + b_n (phi_1 - phi_0)

with a reset after ``nmax`` applications.  The JAX package's default is the
branch-free blend ``chebyshev_apply_blend``; its case selection depends only on
the outer count, so here the application counter is a host integer and the
blend is evaluated with the same association of the arithmetic.

Anderson(m) (``anderson_apply``) is the JAX package's update: least squares on
the residual differences of a ring buffer of the last m (iterate, residual)
pairs, Tikhonov-regularized, with the step clipped to a relative norm.  Its
pair count is a host integer too, so the valid window is a host slice.
Under a sharding scope its sums over the flux are all-reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import tracing
from .shardctx import allsum, current_sharding

__all__ = ["ChebyshevState", "chebyshev_coeffs", "chebyshev_init", "chebyshev_apply_blend",
           "AndersonState", "anderson_init", "anderson_apply"]


class ChebyshevState(NamedTuple):
    it: int              # applications since last reset
    phi0: torch.Tensor   # accelerated iterate n-2
    phi1: torch.Tensor   # accelerated iterate n-1


def chebyshev_coeffs(nmax: int, sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    g = np.arccosh(2.0 / sigma - 1.0)
    n = np.arange(nmax, dtype=np.float64)
    with np.errstate(over="ignore"):
        a = np.cosh((n - 1) * g) / np.cosh(n * g)
        b = np.cosh((n - 2) * g) / np.cosh(n * g)
    a[0], b[0] = 0.0, 0.0
    if nmax > 1:
        a[1] = 2.0 / (2.0 - sigma)
        b[1] = 0.0
    return a, b


def chebyshev_init(phi_like) -> ChebyshevState:
    z = torch.zeros_like(phi_like)
    return ChebyshevState(it=0, phi0=z, phi1=z)


def chebyshev_apply_blend(state: ChebyshevState, phi, apply: bool, nmax: int = 15,
                          sigma: float = 0.98):
    """One accelerator application when ``apply``; returns (new_state, phi_acc).

    All three recurrence cases share ``acc = base + s1 (phi - base) + s2 (phi1 - phi0)``
    (case 0: base = phi, s1 = s2 = 0; case 1: base = phi0, s1 = a_1; case >= 2:
    base = phi1, s1 = (4/sigma) a_n, s2 = b_n).  ``apply=False`` leaves both the
    state and phi unchanged (the blend then folds to acc = phi)."""
    if not apply:
        return state, phi
    a_np, b_np = chebyshev_coeffs(nmax, sigma)
    it = 0 if state.it == nmax else state.it
    case = min(it, 2)
    idx = min(it, nmax - 1)

    def scalar(x):
        with tracing.sync("upload"):
            return torch.tensor(x, dtype=phi.dtype, device=phi.device)

    an, bn = scalar(a_np[idx]), scalar(b_np[idx])
    if case == 0:
        s1, s2, base = scalar(0.0), scalar(0.0), phi
    elif case == 1:
        s1, s2, base = scalar(a_np[1]), scalar(0.0), state.phi0
    else:
        s1, s2, base = (4.0 / sigma) * an, bn, state.phi1
    acc = base + s1 * (phi - base) + s2 * (state.phi1 - state.phi0)
    return ChebyshevState(it + 1, base, acc), acc


class AndersonState(NamedTuple):
    it: int              # number of (x, g(x)) pairs seen
    X: torch.Tensor      # (m, n) history of iterates x_j (flattened)
    F: torch.Tensor      # (m, n) history of residuals f_j = g(x_j) - x_j


def anderson_init(n: int, m: int, dtype, device) -> AndersonState:
    return AndersonState(it=0, X=torch.zeros((m, n), dtype=dtype, device=device),
                         F=torch.zeros((m, n), dtype=dtype, device=device))


def anderson_apply(state: AndersonState, x_prev, gx, beta: float = 1.0, reg: float = 1e-8,
                   max_rel: float = 0.3):
    """Anderson(m) update given the previous iterate ``x_prev`` and its
    fixed-point image ``gx`` (solvers.cpp:772-891): least squares on residual
    differences with Tikhonov ``reg``, mixing ``beta``, the correction clipped
    to ``max_rel`` of ||gx||.  Returns (new_state, x_next) flattened; x_next
    is gx until two pairs have been seen.

    The buffers are pushed in the JAX ``roll`` order (newest last); the rows
    of the differences outside the valid window are zeroed, as the JAX mask
    does.  The (m-1) x (m-1) system goes through ``torch.linalg.solve_ex``,
    which checks nothing on the host (``solve`` would read its status back
    every outer).

    Under a sharding scope the buffers hold the rank's slab: its local Gram
    matrix and right-hand side are summed over the ranks in one all-reduce,
    every rank solves the same small system, and the two squared norms take
    one more (the step needs theta)."""
    m = state.X.shape[0]
    x_prev = x_prev.reshape(-1)
    gx = gx.reshape(-1)
    f = gx - x_prev

    X = torch.cat((state.X[1:], x_prev.unsqueeze(0)))
    F = torch.cat((state.F[1:], f.unsqueeze(0)))
    it = state.it + 1

    k = min(it, m)  # valid history length
    dF = F[1:] - F[:-1]  # (m-1, n)
    dX = X[1:] - X[:-1]
    invalid = (m - 1) - (k - 1)  # the leading difference rows outside the window
    dF[:invalid] = 0.0
    dX[:invalid] = 0.0

    gram, rhs = allsum(dF @ dF.T, dF @ f)
    G = gram + reg * torch.eye(m - 1, dtype=x_prev.dtype, device=x_prev.device)
    theta = torch.linalg.solve_ex(G, rhs).result

    correction = theta @ (dX + dF)
    x_acc = x_prev + beta * f - correction

    step = x_acc - gx
    if current_sharding() is None:
        step_norm = torch.linalg.vector_norm(step)
        x_norm = torch.linalg.vector_norm(gx)
    else:  # the step depends on theta: a second all-reduce
        step_sq, x_sq = allsum(torch.sum(step * step), torch.sum(gx * gx))
        step_norm, x_norm = torch.sqrt(step_sq), torch.sqrt(x_sq)
    scale = torch.clamp(max_rel * x_norm / torch.where(step_norm == 0, 1.0, step_norm), max=1.0)
    x_acc = gx + scale * step

    # need >= 2 samples for a meaningful update
    return AndersonState(it=it, X=X, F=F), (x_acc if it >= 2 else gx)
