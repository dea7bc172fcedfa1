"""Batched symmetric tridiagonal solves (port of ``neutfem_tpu/ops/tridiag.py``).

The per-direction A blocks are exactly tridiagonal along mesh lines; they are
factored once at build time (``native.tridiag_ldlt_batch``) and every solve is
one Thomas sweep, ``ops.thomas.thomas_solve``: the plain PyTorch recurrence on
the CPU, the K4 kernel on CUDA.
"""

from __future__ import annotations

from .thomas import thomas_solve

__all__ = ["tridiag_solve"]


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
