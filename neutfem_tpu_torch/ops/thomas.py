"""Batched Thomas (LDL^T) solve along one axis — K4 and K4′.

Port of ``neutfem_tpu/ops/pallas_tridiag.py`` (``thomas_solve``).  On a CUDA
tensor the wrapper launches a hand-written kernel (``csrc/thomas_rows.cu``,
``csrc/thomas_wide_rows.cu``); on a CPU tensor it runs the plain PyTorch version below.
There is no other route: a CUDA tensor the kernel does not take raises.

The TPU package dispatches by layout: ``_solve_z`` (axis -3), ``_solve_rows``
(axis -2), ``_solve_y`` (axis -2 with rows too wide for ``_solve_rows``: the 2D
y solves, K4′) and ``_solve_transpose`` (axis -1).  Here the K4 layouts go to
one tiled kernel (``csrc/thomas_rows.cu``: a tile of lines per block, each
line cut into chunks, staged through shared memory face-major where the
lines' neighbours are contiguous, line-major along the minor axis; at the
tile ``thomas_tile`` picks; launches counted under ``tracing``'s
``"thomas.thomas_rows"``).  The
K4′ layout (``wide_rows``) has few, long lines (912 lines of 913 faces per
group at ZION 48x48); its kernel (``csrc/thomas_wide_rows.cu``) stages a
tile of 8 neighbouring lines face-major in shared memory, cuts each line into
32 chunks, one thread each, and composes the chunks' carries in order, at
the tile ``wide_tile`` picks; launches counted under
``"thomas.thomas_wide_rows"``.

    forward:  z_0 = r_0;              z_i = r_i - l_{i-1} z_{i-1}
    diagonal: x_{n-1} = z_{n-1} d_{n-1}
    backward: x_i = z_i d_i - l_i x_{i+1}
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from . import cuda_lib
from .fused import SMEM_PER_BLOCK

__all__ = ["thomas_solve", "thomas_solve_plain", "thomas_tile", "wide_rows", "wide_smem",
           "wide_tile"]

#: The tiled K4's tile, lines per block and chunks per line (K1's, the
#: kernel it copies).
THOMAS_LINES, THOMAS_CHUNKS = 32, 8
#: The tiled K4′'s chunks per line (powers of two) and most threads per
#: block.
WIDE_CHUNKS, WIDE_THREADS = (16, 32, 64, 128, 256), 256
#: ``wide_tile`` takes the fewest chunks that keep a chunk within
#: ``WIDE_LEN`` elements (the serial steps of a sweep), and keeps at least
#: ``WIDE_MIN_LINES`` lines a block while it halves them to fill the card (8
#: float32 values are one 32-byte sector of a face row).
WIDE_LEN, WIDE_MIN_LINES = 32, 8
#: The TPU dispatch's block budget (``pallas_tridiag._VMEM_BUDGET``, 8 MiB).
_ROWS_BUDGET = 8 * 2**20


def wide_rows(shape, axis: int) -> bool:
    """True at the K4′ layout: a solve along axis -2 whose (n, M) rows are too
    wide for the TPU's full-row blocks (8 n M 4 bytes above a quarter of the
    budget, ``pallas_tridiag.py:297-323``) — the 2D y solves."""
    ndim = len(shape)
    if ndim < 3 or axis % ndim != ndim - 2:
        return False
    n, M = shape[-2], shape[-1]
    return _ROWS_BUDGET // (8 * n * M * 4) < 4


def thomas_smem(n: int, tl: int, ch: int, elem_bytes: int, line_major: bool) -> int:
    """Shared memory bytes of one tile of the tiled K4: the r/z/x, d and l rows
    of ``tl`` lines of ``n`` elements (line-major rows padded to an odd
    length), and the chunks' four carry rows (``csrc/thomas_rows.cu``)."""
    row = (n | 1) if line_major else n
    return (3 * row + 4 * ch) * tl * elem_bytes


def thomas_tile(n: int, dtype, line_major: bool):
    """(lines per block, chunks per line) of the tiled K4 for lines of ``n``
    elements: ``THOMAS_LINES`` x ``THOMAS_CHUNKS``, the lines halved while the
    tile exceeds the card's shared memory, the chunks doubled where that
    would leave a block under one warp; at one line per block a tile that
    still does not fit is refused at launch, and the wrapper raises."""
    tl, ch = THOMAS_LINES, THOMAS_CHUNKS
    elem = torch.finfo(dtype).bits // 8
    while tl > 1 and thomas_smem(n, tl, ch, elem, line_major) > SMEM_PER_BLOCK:
        tl //= 2
        if tl * ch < 32:
            ch *= 2
    return tl, ch


def wide_smem(n: int, tl: int, ch: int, elem_bytes: int) -> int:
    """Shared memory bytes of one tile of the tiled K4′: the r/z/x, d and l
    rows of ``tl`` lines of ``n`` elements and the chunks' four carry rows
    (``csrc/thomas_wide_rows.cu``)."""
    return (3 * n + 4 * ch) * tl * elem_bytes


def wide_tile(n: int, outer: int, inner: int, sms: int, dtype=torch.float32):
    """(lines per block, chunks per line) of the tiled K4′ for ``outer`` slabs
    of ``inner`` lines of ``n`` elements on a card of ``sms`` SMs: the fewest
    chunks (``WIDE_CHUNKS``) that keep a chunk within ``WIDE_LEN`` elements
    (the most chunks for longer lines), and the most lines (``WIDE_THREADS``
    // chunks, at most 32) halved while the tile exceeds the card's shared
    memory, then while the launch would leave an SM without a block, down to
    ``WIDE_MIN_LINES``.  None where one line does not fit."""
    ch = next((c for c in WIDE_CHUNKS if -(-n // c) <= WIDE_LEN), WIDE_CHUNKS[-1])
    elem = torch.finfo(dtype).bits // 8
    tl = min(32, WIDE_THREADS // ch)
    while tl > 1 and wide_smem(n, tl, ch, elem) > SMEM_PER_BLOCK:
        tl //= 2
    if wide_smem(n, tl, ch, elem) > SMEM_PER_BLOCK:
        return None
    while tl > WIDE_MIN_LINES and outer * -(-inner // tl) < sms:
        tl //= 2
    return tl, ch


_SMS: dict = {}  # device index -> SM count


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def thomas_solve_plain(rhs, dinv, l, axis: int):
    """Plain PyTorch version: the recurrence along ``axis``, vectorized over
    every other axis.  ``dinv`` has rhs's shape; ``l`` one entry fewer along
    ``axis``."""
    # the carries run as a loop over rows of the solve axis, in place; the
    # diagonal scaling of every row at once: each entry takes the same
    # floating-point operations, in the same order, as a row-by-row loop
    out = rhs.movedim(axis, 0).clone(memory_format=torch.contiguous_format)
    ll = l.movedim(axis, 0).unbind(0)
    n = out.shape[0]
    rows = out.unbind(0)
    tmp = torch.empty_like(rows[0])
    for i in range(1, n):
        torch.mul(ll[i - 1], rows[i - 1], out=tmp)
        rows[i].sub_(tmp)
    out *= dinv.movedim(axis, 0)
    for j in range(n - 2, -1, -1):
        torch.mul(ll[j], rows[j + 1], out=tmp)
        rows[j].sub_(tmp)
    return out.movedim(0, axis).contiguous()


def thomas_solve(rhs, dinv, l, axis: int, tile=None):
    """Solve T x = rhs along ``axis`` with precomputed LDL^T factors.

    ``dinv`` must have rhs's shape and ``l`` rhs's shape with n-1 entries along
    ``axis`` (callers broadcast first).  ``tile``: the tiled kernel's (lines,
    chunks) in place of ``thomas_tile``'s (``wide_tile``'s at the K4′
    layout).  Returns a new tensor."""
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
    ptrs = (rhs.data_ptr(), dinv.data_ptr(), l.data_ptr(), out.data_ptr(), n)
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    suffix = "f32" if rhs.dtype == torch.float32 else "f64"
    if wide_rows(rhs.shape, axis):
        tile = tile or wide_tile(n, lines // inner, inner, _sm_count(rhs.device), rhs.dtype)
        if tile is None:
            raise ValueError(f"thomas_solve (K4′): one line of {n} elements exceeds the "
                             f"card's shared memory")
        key, what = "thomas_wide_rows", f"thomas_solve (K4′ tiled kernel, tile {tile}, n {n})"
        err = getattr(lib, f"neutfem_thomas_wide_rows_{suffix}")(*ptrs, lines // inner, inner,
                                                                  *tile, stream)
    else:
        tile = tile or thomas_tile(n, rhs.dtype, inner == 1)
        key, what = "thomas_rows", f"thomas_solve (tiled kernel, tile {tile}, n {n})"
        err = getattr(lib, f"neutfem_thomas_rows_{suffix}")(*ptrs, lines // inner, inner, *tile,
                                                             stream)
    cuda_lib.check(err, what)
    tracing.count(f"thomas.{key}")
    return out
