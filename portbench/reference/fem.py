"""Reference-element tensors of the mixed RT_k / P_k pair on a Cartesian mesh.

Plain numpy, float64.  A frozen copy of the mathematics of
``neutfem_tpu_torch/elements.py`` and ``neutfem_tpu_torch/fespace.py`` as of
814381f (the 1D families, their Gauss-Legendre integrals, the flux modes and
the per-direction pairing tensors), written out here so that the reference
imports nothing of the program.  The basis on [-1, 1]:

* longitudinal current functions ``u_0 = (1 - x)/2`` (left face), ``u_1 =
  (1 + x)/2`` (right face), ``u_{2+l} = (1 - x^2) P_l`` (bubbles, l < k);
* flux: tensor Legendre ``P_p`` per active axis, p <= k;
* ``M1[i, j] = int u_i u_j``, ``D1[p, i] = int P_p u_i'``, ``leg_mass[n] = 2/(2n+1)``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np

__all__ = ["Direction", "Space", "make_space"]

#: (nz, ny, nx) grid axis that direction d (0 = x, 1 = y, 2 = z) runs along.
GRID_AXIS = {0: 2, 1: 1, 2: 0}


def _legendre(nmax: int, x: np.ndarray) -> np.ndarray:
    out = np.zeros((nmax + 1, x.size))
    out[0] = 1.0
    if nmax >= 1:
        out[1] = x
    for n in range(1, nmax):
        out[n + 1] = ((2 * n + 1) * x * out[n] - n * out[n - 1]) / (n + 1)
    return out


def _legendre_deriv(nmax: int, x: np.ndarray) -> np.ndarray:
    """P'_n at interior points x (the quadrature's nodes never reach +-1)."""
    P = _legendre(nmax, x)
    out = np.zeros_like(P)
    for n in range(1, nmax + 1):
        out[n] = n * (P[n - 1] - x * P[n]) / (1 - x ** 2)
    return out


def _long_basis(k: int, x: np.ndarray):
    U = np.zeros((k + 2, x.size))
    dU = np.zeros((k + 2, x.size))
    U[0], U[1] = 0.5 * (1 - x), 0.5 * (1 + x)
    dU[0], dU[1] = -0.5, 0.5
    if k > 0:
        P, dP = _legendre(k - 1, x), _legendre_deriv(k - 1, x)
        for l in range(k):
            U[2 + l] = (1 - x ** 2) * P[l]
            dU[2 + l] = -2 * x * P[l] + (1 - x ** 2) * dP[l]
    return U, dU


@dataclasses.dataclass(frozen=True)
class Direction:
    d: int              # 0 = x, 1 = y, 2 = z
    axis: int           # its axis in (nz, ny, nx)
    T: int              # transverse modes
    m_t: np.ndarray     # (T,) transverse mass of each mode
    BX: np.ndarray      # (k + 2, P, T): int P_p div(u_i P_t) over the element
    n_tr: int           # active transverse axes


@dataclasses.dataclass(frozen=True)
class Space:
    dim: int
    k: int
    P: int
    M1: np.ndarray          # (k + 2, k + 2)
    w_mode: np.ndarray      # (P,) Legendre mass of each flux mode
    dirs: Tuple[Direction, ...]


def make_space(dim: int, k: int) -> Space:
    """The RT_k-P_k space of a ``dim``-dimensional Cartesian mesh."""
    xq, wq = np.polynomial.legendre.leggauss(4 * k + 6)
    U, dU = _long_basis(k, xq)
    Pq = _legendre(k, xq)
    M1 = np.einsum("iq,jq,q->ij", U, U, wq)
    D1 = np.einsum("pq,iq,q->pi", Pq, dU, wq)
    leg_mass = 2.0 / (2.0 * np.arange(k + 1) + 1.0)

    active = [True, dim >= 2, dim == 3]  # x, y, z
    ranges = [range(k + 1) if active[a] else range(1) for a in range(3)]
    modes = np.array([(px, py, pz) for pz in ranges[2] for py in ranges[1] for px in ranges[0]])
    P = len(modes)
    w_mode = np.ones(P)
    for a in range(3):
        if active[a]:
            w_mode = w_mode * leg_mass[modes[:, a]]

    dirs = []
    for d in range(3):
        if not active[d]:
            continue
        tr = [a for a in range(3) if a != d and active[a]]
        tuples = [(t0, t1) for t1 in range(k + 1) for t0 in range(k + 1)] if len(tr) == 2 \
            else list(itertools.product(*[range(k + 1)] * len(tr)))
        index = {tt: j for j, tt in enumerate(tuples)}
        m_t = np.array([np.prod([leg_mass[t] for t in tt]) for tt in tuples])
        BX = np.zeros((k + 2, P, len(tuples)))
        for p in range(P):
            t = index[tuple(int(modes[p, a]) for a in tr)]
            BX[:, p, t] = D1[int(modes[p, d]), :] * np.prod([leg_mass[int(modes[p, a])] for a in tr])
        dirs.append(Direction(d=d, axis=GRID_AXIS[d], T=len(tuples), m_t=m_t, BX=BX, n_tr=len(tr)))
    return Space(dim=dim, k=k, P=P, M1=M1, w_mode=w_mode, dirs=tuple(dirs))
