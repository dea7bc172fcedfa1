"""Batched symmetric tridiagonal solves (port of ``neutfem_tpu/ops/tridiag.py``).

The per-direction A blocks are exactly tridiagonal along mesh lines; they are
factored once at build time (``native.tridiag_ldlt_batch``) and every solve is
one Thomas sweep, ``ops.thomas.thomas_solve``: the plain PyTorch recurrence on
the CPU, the K4 kernel on CUDA.

``affine_scan`` / ``scan_solve`` are the JAX package's associative-scan form
of the same two substitutions (``neutfem_tpu/ops/tridiag.py:50-81``), which it
runs where the solve axis is cut over devices; here
``ops/parttri.tridiag_solve_scan`` runs them on a rank's segment with the
carries between ranks written out.  Elementwise PyTorch at log depth: the JAX
package runs them as XLA, not as a Pallas kernel.
"""

from __future__ import annotations

import torch

from .thomas import thomas_solve

__all__ = ["tridiag_solve", "affine_pairs", "affine_scan", "scan_solve"]


def tridiag_solve(rhs, dinv, l, axis: int):
    """Solve T x = rhs with precomputed LDL^T factors (dinv, l) along ``axis``.

    dinv / l are broadcast against rhs (l with n-1 entries along ``axis``) and
    made contiguous, as the kernel takes them.
    Forward:  z_i = r_i - l_{i-1} z_{i-1};  diagonal: w = z * dinv;
    backward: x_i = w_i - l_i x_{i+1}.
    """
    axis = axis % rhs.ndim
    n = rhs.shape[axis]
    dinv_b = dinv.expand(rhs.shape).contiguous()
    lb = l.expand(rhs.shape[:axis] + (n - 1,) + rhs.shape[axis + 1:]).contiguous()
    return thomas_solve(rhs.contiguous(), dinv_b, lb, axis)


def affine_pairs(a, b, axis: int, reverse: bool = False):
    """The inclusive composition (A_i, B_i) of the affine maps z -> a_j z +
    b_j along ``axis``: z_i = A_i z_{-1} + B_i for any carry-in z_{-1}
    (``reverse``: from the far end, z_i = A_i z_n + B_i).  ``a`` has b's
    length along ``axis`` and broadcasts against it (A keeps a's shape).

    Log depth (Hillis-Steele): at offset d each element composes with the
    one d before it, with the JAX combine (a_r a_l, a_r b_l + b_r).  No
    division: products of |a| < 1 underflow harmlessly to 0."""
    axis = axis % b.ndim
    n = b.shape[axis]
    d = 1
    while d < n:
        # element i composes with its partner d before it in the scan's order
        # (i - d, or i + d in reverse); the d elements without one stay
        own, partner = (0, d) if reverse else (d, 0)
        a_r, a_l = a.narrow(axis, own, n - d), a.narrow(axis, partner, n - d)
        b_r, b_l = b.narrow(axis, own, n - d), b.narrow(axis, partner, n - d)
        new_a, new_b = a_r * a_l, a_r * b_l + b_r
        if reverse:
            a = torch.cat([new_a, a.narrow(axis, n - d, d)], dim=axis)
            b = torch.cat([new_b, b.narrow(axis, n - d, d)], dim=axis)
        else:
            a = torch.cat([a.narrow(axis, 0, d), new_a], dim=axis)
            b = torch.cat([b.narrow(axis, 0, d), new_b], dim=axis)
        d *= 2
    return a, b


def affine_scan(a, b, axis: int, reverse: bool = False):
    """Solve z_i = a_i z_{i-1} + b_i (inclusive, z_{-1} = 0) along ``axis``;
    ``reverse``: z_i = a_i z_{i+1} + b_i (z_n = 0).  The counterpart of
    ``neutfem_tpu.ops.tridiag.affine_scan`` (``a`` may broadcast against
    ``b``)."""
    return affine_pairs(a, b, axis, reverse)[1]


def scan_solve(rhs, dinv, l, axis: int):
    """Solve T x = rhs with LDL^T factors (dinv, l) by the two affine
    recurrences (the JAX ``_scan_solve``): a_fwd = [0, -l_0, ..., -l_{n-2}],
    w = z * dinv, a_bwd = [-l_0, ..., -l_{n-2}, 0].  dinv / l broadcast
    against rhs (l with n-1 entries along ``axis``)."""
    axis = axis % rhs.ndim
    zero = l.new_zeros(l.shape[:axis] + (1,) + l.shape[axis + 1:])
    z = affine_scan(torch.cat([zero, -l], dim=axis), rhs, axis)
    return affine_scan(torch.cat([-l, zero], dim=axis), z * dinv, axis, reverse=True)
