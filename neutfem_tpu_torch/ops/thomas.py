"""Batched Thomas (LDL^T) solve along one axis — K4.

Port of ``neutfem_tpu/ops/pallas_tridiag.py`` (``thomas_solve``).  On a CUDA
tensor the wrapper launches the hand-written kernel of ``csrc/thomas.cu``; on a
CPU tensor it runs the plain PyTorch version below.  There is no other route:
a CUDA tensor the kernel does not take raises.

    forward:  z_0 = r_0;              z_i = r_i - l_{i-1} z_{i-1}
    diagonal: x_{n-1} = z_{n-1} d_{n-1}
    backward: x_i = z_i d_i - l_i x_{i+1}
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

__all__ = ["thomas_solve", "thomas_solve_plain", "LAUNCHES", "reset_launches"]

#: Kernel launches of this module (incremented where the kernel is launched).
LAUNCHES = {"thomas": 0}


def reset_launches() -> None:
    LAUNCHES["thomas"] = 0


def thomas_solve_plain(rhs, dinv, l, axis: int):
    """Plain PyTorch version: the recurrence along ``axis``, vectorized over
    every other axis.  ``dinv`` has rhs's shape; ``l`` one entry fewer along
    ``axis``."""
    r = rhs.movedim(axis, 0)
    d = dinv.movedim(axis, 0)
    ll = l.movedim(axis, 0)
    n = r.shape[0]
    out = torch.empty_like(r)
    out[0] = r[0]
    for i in range(1, n):
        out[i] = r[i] - ll[i - 1] * out[i - 1]
    out[n - 1] = out[n - 1] * d[n - 1]
    for j in range(n - 2, -1, -1):
        out[j] = out[j] * d[j] - ll[j] * out[j + 1]
    return out.movedim(0, axis).contiguous()


def thomas_solve(rhs, dinv, l, axis: int):
    """Solve T x = rhs along ``axis`` with precomputed LDL^T factors.

    ``dinv`` must have rhs's shape and ``l`` rhs's shape with n-1 entries along
    ``axis`` (callers broadcast first).  Returns a new tensor."""
    if rhs.device.type == "cpu":
        return thomas_solve_plain(rhs, dinv, l, axis)
    if rhs.device.type != "cuda":
        raise NotImplementedError(f"thomas_solve: no kernel for device {rhs.device}")
    axis = axis % rhs.ndim
    n = rhs.shape[axis]
    lshape = rhs.shape[:axis] + (n - 1,) + rhs.shape[axis + 1:]
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thomas_solve: unsupported dtype {rhs.dtype}")
    for name, t, shape in (("dinv", dinv, rhs.shape), ("l", l, lshape)):
        if t.device != rhs.device or t.dtype != rhs.dtype:
            raise TypeError(f"thomas_solve: {name} must be {rhs.dtype} on {rhs.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"thomas_solve: {name} shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"thomas_solve: {name} must be contiguous")
    if not rhs.is_contiguous():
        raise ValueError("thomas_solve: rhs must be contiguous")
    if n < 1 or rhs.numel() == 0:
        raise ValueError(f"thomas_solve: empty system {tuple(rhs.shape)}")

    inner = math.prod(rhs.shape[axis + 1:])
    lines = rhs.numel() // n
    out = torch.empty_like(rhs)
    lib = cuda_lib.library()
    fn = lib.neutfem_thomas_f32 if rhs.dtype == torch.float32 else lib.neutfem_thomas_f64
    err = fn(rhs.data_ptr(), dinv.data_ptr(), l.data_ptr(), out.data_ptr(), n, lines,
             inner, torch.cuda.current_stream(rhs.device).cuda_stream)
    cuda_lib.check(err, "thomas_solve")
    LAUNCHES["thomas"] += 1
    return out
