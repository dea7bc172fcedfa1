"""Batched Thomas (LDL^T) solve along one axis — K4 and K4′.

Port of ``neutfem_tpu/ops/pallas_tridiag.py`` (``thomas_solve``).  On a CUDA
tensor the wrapper launches the hand-written kernel of ``csrc/thomas.cu``; on a
CPU tensor it runs the plain PyTorch version below.  There is no other route:
a CUDA tensor the kernel does not take raises.

The TPU package dispatches by layout: ``_solve_z`` (axis -3), ``_solve_rows``
(axis -2), ``_solve_y`` (axis -2 with rows too wide for ``_solve_rows``: the 2D
y solves, K4′) and ``_solve_transpose`` (axis -1).  Here one stride kernel,
one thread per line, serves the K4 layouts (launches counted under
``"thomas"``).  The K4′ layout (``wide_rows``) has few, long lines (912 lines
of 913 faces per group at ZION 48x48), which one thread per line would run on
a few of the card's SMs with ~2n dependent steps each; its kernel splits each
line into chunks, one thread each, and stitches the chunks' recurrences
together (``csrc/thomas.cu``; launches counted under ``"thomas_y"``).

    forward:  z_0 = r_0;              z_i = r_i - l_{i-1} z_{i-1}
    diagonal: x_{n-1} = z_{n-1} d_{n-1}
    backward: x_i = z_i d_i - l_i x_{i+1}
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

__all__ = ["thomas_solve", "thomas_solve_plain", "wide_rows", "LAUNCHES", "reset_launches"]

#: Kernel launches of this module (incremented where the kernel is launched):
#: "thomas" K4, "thomas_y" K4′.
LAUNCHES = {"thomas": 0, "thomas_y": 0}

#: The TPU dispatch's block budget (``pallas_tridiag._VMEM_BUDGET``, 8 MiB).
_ROWS_BUDGET = 8 * 2**20


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def wide_rows(shape, axis: int) -> bool:
    """True at the K4′ layout: a solve along axis -2 whose (n, M) rows are too
    wide for the TPU's full-row blocks (8 n M 4 bytes above a quarter of the
    budget, ``pallas_tridiag.py:297-323``) — the 2D y solves."""
    ndim = len(shape)
    if ndim < 3 or axis % ndim != ndim - 2:
        return False
    n, M = shape[-2], shape[-1]
    return _ROWS_BUDGET // (8 * n * M * 4) < 4


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
    key = "thomas_y" if wide_rows(rhs.shape, axis) else "thomas"
    name = "neutfem_thomas_wide" if key == "thomas_y" else "neutfem_thomas"
    fn = getattr(lib, f"{name}_{'f32' if rhs.dtype == torch.float32 else 'f64'}")
    err = fn(rhs.data_ptr(), dinv.data_ptr(), l.data_ptr(), out.data_ptr(), n, lines,
             inner, torch.cuda.current_stream(rhs.device).cuda_stream)
    cuda_lib.check(err, f"thomas_solve ({key})")
    LAUNCHES[key] += 1
    return out
