"""Reference-element tensors for the mixed RT_k / P_m pair on [-1, 1]^d.

Port of ``neutfem_tpu/elements.py`` (host-side numpy, unchanged math).  Because
the basis is a tensor product of 1D families and the mesh is Cartesian, every
integral separates into 1D factors, precomputed here once.

1D families (Hébert's mixed-dual structure, reference FEM.hpp:549-621):

* Longitudinal J basis (direction of the vector component), ``nlong = k + 2`` functions::

      u_0(x) = (1 - x)/2          # "left face"
      u_1(x) = (1 + x)/2          # "right face"
      u_{2+l}(x) = (1 - x^2) P_l(x),  l = 0..k-1   # interior "bubbles", vanish at faces

* Flux basis: tensor Legendre P_p per axis, p <= m (FEM.hpp:642-679); L2-orthogonal, so
  all flux mass matrices are diagonal with weights ``prod_d 2/(2 p_d + 1)``.

Precomputed tensors:

* ``M1[i, j]    = ∫ u_i u_j dx``                 (the 1D RT mass; tridiagonal-generating)
* ``D1[p, i]    = ∫ P_p u_i' dx``                (the 1D divergence pairing)
* ``leg_mass[n] = ∫ P_n^2 dx = 2/(2n+1)``
* static condensation of the bubble block of ``M1``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["ElementTensors", "element_tensors", "legendre_table", "gauss_rule"]


def gauss_rule(n: int):
    """n-point Gauss-Legendre rule on [-1, 1]."""
    return np.polynomial.legendre.leggauss(n)


def legendre_table(nmax: int, x: np.ndarray) -> np.ndarray:
    """P_0..P_nmax at points x, shape (nmax+1, len(x)). Bonnet recurrence."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros((nmax + 1, x.size))
    out[0] = 1.0
    if nmax >= 1:
        out[1] = x
    for n in range(1, nmax):
        out[n + 1] = ((2 * n + 1) * x * out[n] - n * out[n - 1]) / (n + 1)
    return out


def legendre_deriv_table(nmax: int, x: np.ndarray) -> np.ndarray:
    """P'_0..P'_nmax at points x, via (1-x^2) P'_n = n (P_{n-1} - x P_n) with limits."""
    x = np.asarray(x, dtype=np.float64)
    P = legendre_table(nmax, x)
    out = np.zeros_like(P)
    inner = np.abs(x) < 1.0 - 1e-13
    for n in range(1, nmax + 1):
        out[n, inner] = n * (P[n - 1, inner] - x[inner] * P[n, inner]) / (1 - x[inner] ** 2)
        # At x=±1: P'_n(±1) = (±1)^{n-1} n(n+1)/2
        edge = ~inner
        out[n, edge] = np.sign(x[edge]) ** (n - 1) * n * (n + 1) / 2.0
    return out


def _long_basis(k: int, x: np.ndarray):
    """Values and derivatives of the k+2 longitudinal J functions at points x."""
    x = np.asarray(x, dtype=np.float64)
    n = k + 2
    U = np.zeros((n, x.size))
    dU = np.zeros((n, x.size))
    U[0] = 0.5 * (1 - x)
    U[1] = 0.5 * (1 + x)
    dU[0] = -0.5
    dU[1] = 0.5
    if k > 0:
        P = legendre_table(k - 1, x)
        dP = legendre_deriv_table(k - 1, x)
        for l in range(k):
            U[2 + l] = (1 - x**2) * P[l]
            dU[2 + l] = -2 * x * P[l] + (1 - x**2) * dP[l]
    return U, dU


@dataclasses.dataclass(frozen=True)
class ElementTensors:
    """All 1D reference-element tensors for a given (rt_order k, p_order m)."""

    k: int
    m: int
    nlong: int          # k + 2 longitudinal J functions
    nbub: int           # k interior bubbles
    M1: np.ndarray      # (nlong, nlong)  ∫ u_i u_j
    M1_lumped: np.ndarray  # (nlong,) row sums of M1 (mass lumping -> finite difference)
    D1: np.ndarray      # (m+1, nlong)    ∫ P_p u_i'
    leg_mass: np.ndarray  # (max(k, m)+1,) 2/(2n+1)
    # Static condensation of the bubble block (empty arrays when k == 0):
    K: np.ndarray        # (2, 2)  M_ff - M_fb M_bb^-1 M_bf  (condensed face block)
    Mbb_inv: np.ndarray  # (nbub, nbub)
    G: np.ndarray        # (nbub, 2) = M_bb^-1 M_bf : bubble response to face values
    # End-point values of longitudinal functions (u_i(-1), u_i(+1)); faces only nonzero.
    u_left: np.ndarray   # (nlong,)
    u_right: np.ndarray  # (nlong,)

    def eval_long(self, x: np.ndarray):
        return _long_basis(self.k, x)


@lru_cache(maxsize=None)
def element_tensors(k: int, m: int) -> ElementTensors:
    if k < 0 or m < 0:
        raise ValueError("orders must be >= 0")
    if m > k:
        # Inf-sup guard of the reference (NeutFEM.cpp:149-169): flux order capped at k.
        raise ValueError(f"p_order (={m}) must be <= rt_order (={k})")
    nlong = k + 2
    nq = 2 * (k + m) + 6
    xq, wq = gauss_rule(nq)
    U, dU = _long_basis(k, xq)
    P = legendre_table(m, xq)

    M1 = np.einsum("iq,jq,q->ij", U, U, wq)
    D1 = np.einsum("pq,iq,q->pi", P, dU, wq)
    leg_mass = 2.0 / (2.0 * np.arange(max(k, m) + 1) + 1.0)

    if k > 0:
        Mff = M1[:2, :2]
        Mfb = M1[:2, 2:]
        Mbb = M1[2:, 2:]
        Mbb_inv = np.linalg.inv(Mbb)
        G = Mbb_inv @ Mfb.T
        K = Mff - Mfb @ Mbb_inv @ Mfb.T
    else:
        Mbb_inv = np.zeros((0, 0))
        G = np.zeros((0, 2))
        K = M1.copy()

    one = np.array([1.0])
    u_left = _long_basis(k, -one)[0][:, 0]
    u_right = _long_basis(k, one)[0][:, 0]

    return ElementTensors(
        k=k,
        m=m,
        nlong=nlong,
        nbub=k,
        M1=M1,
        M1_lumped=M1.sum(axis=1),
        D1=D1,
        leg_mass=leg_mass,
        K=K,
        Mbb_inv=Mbb_inv,
        G=G,
        u_left=u_left,
        u_right=u_right,
    )
