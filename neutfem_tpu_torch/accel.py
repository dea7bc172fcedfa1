"""Chebyshev acceleration of the power iteration (port of ``neutfem_tpu/accel.py``).

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
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["ChebyshevState", "chebyshev_coeffs", "chebyshev_init", "chebyshev_apply_blend"]


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
