"""Fused RT0 Schur directions: acc += B_d A_d^{-1} B_d^T v in one pass — K1, K2, K3, K5.

Port of ``neutfem_tpu/ops/pallas_fused.py`` (``fused_schur_dir`` on axis -3,
``fused_schur_y_pre``, ``fused_schur_x_pre``, and ``fused_schur_dir`` on a
group-batched flux, which launches ``_fused_y`` / ``_fused_x`` (K5) and
``_fused_z`` with its batch B = ng).  Per line along direction d
(f = face 0..n, e = cell 0..n-1; bx0/bx1 the two scalar divergence-pairing
entries, si = 1/m_t):

    rF_f  = bx1 v_{f-1} + bx0 v_f                (v out of range = 0)
    z_0   = rF_0 si;    z_f = rF_f si - l_{f-1} z_{f-1}
    F_n   = z_n dm_n;   F_f = z_f dm_f - l_f F_{f+1}          [dm = dinv*mask]
    out_e = acc_e + (bx0 F_e + bx1 F_{e+1})

On a CUDA tensor each wrapper launches a hand-written tiled kernel (a tile
of lines per block, each line cut into chunks, staged through shared memory;
the batched ones take the group from their grid): the y and x directions,
one group (K2, K3) or group-batched (K5), the kernels of
``csrc/fused_rows.cu`` at the tile ``rows_tile`` picks; the z direction (K1)
and its group batch those of ``csrc/fused_z_rows.cu``, which stage the tile
face-major, at the tile ``z_tile`` picks.  On a CPU tensor every wrapper
runs the plain PyTorch version.  A CUDA tensor the
kernel does not take, or a launch the card refuses, raises; there is no
decline path.  A launch counts under ``tracing``'s ``fused.<direction>_rows``
("fused.z_rows", "fused.y_rows", "fused.x_rows": K1, K2, K3) or
``fused.<direction>_batched_rows`` (K1's batch, K5).

Like the TPU kernels, which alias the accumulator input to the output, the
wrappers UPDATE ``acc`` IN PLACE and return it.

Operands of the one-group wrappers (v and acc single-group, every leading dim
of size 1):

* z: dm (nz+1, ny, nx), l (nz, ny, nx) — the natural face layout;
* y: dmT (ny+1, nz, nx), lT (ny, nz, nx) — staged solve-axis-major;
* x: dmT (nx+1, nz*ny), lT (nx, nz*ny) — staged transposed.

In all three, the face entry f of line b sits at ``b + f*lines``.  The
``*_batched`` wrappers take a group-batched flux (ng, 1, nz, ny, nx), as the
Jacobi group sweep hands ``schur_matvec`` every group at once, and the
per-group stacks of the same operands, (ng, ...) in front; one launch covers
every group's lines.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from . import cuda_lib

__all__ = ["fused_schur_z", "fused_schur_y_pre", "fused_schur_x_pre",
           "fused_schur_z_batched", "fused_schur_y_batched", "fused_schur_x_batched",
           "fused_dir_plain", "rows_tile", "z_tile"]

#: Lines per block of the tiled kernel by dtype, and chunks per line: in
#: float32 the best or within a few per cent of the best tile chip_smoke.py
#: [3] sweeps at ZION, KOEBERG and IAEA-3D 6x6x4 (PERF.md); in float64 the
#: most lines whose tile holds ZION's 913 faces in shared memory.
ROWS_LINES = {torch.float32: 8, torch.float64: 4}
ROWS_CHUNKS = 32
#: The tile of the z kernels (K1 and its batch, ``csrc/fused_z_rows.cu``),
#: lines per block and chunks per line: within 2% of the best tile
#: chip_smoke.py [3] sweeps at IAEA-3D 6x6x4, 8x8x8 and the two-group batch
#: (PERF.md).
Z_LINES, Z_CHUNKS = 32, 8
#: The H100's shared memory per block (the opt-in limit, bytes).
SMEM_PER_BLOCK = 232448


def fused_dir_plain(acc, v, dm, l, axis: int, bx0: float, bx1: float, si: float):
    """Plain PyTorch version in the natural layout: dm (n+1) and l (n) entries
    along ``axis`` of v's spatial shape, broadcastable against v.  Returns the
    new accumulator (does not touch ``acc``)."""
    axis = axis % v.ndim
    n = v.shape[axis]
    vv = v.movedim(axis, 0)
    fshape = v.shape[:axis] + (n + 1,) + v.shape[axis + 1:]
    dd = dm.expand(fshape).movedim(axis, 0)
    ll = l.expand(v.shape).movedim(axis, 0).unbind(0)
    # every face's scaled rhs at once (rF_0 = bx0 v_0, rF_f = bx1 v_{f-1} +
    # bx0 v_f, rF_n = bx1 v_{n-1}; times si), then only the carries run as a
    # loop: each entry takes the same floating-point operations, in the same
    # order, as a face-by-face loop (no operation is fused across another)
    z = torch.empty((n + 1,) + vv.shape[1:], dtype=v.dtype, device=v.device)
    z[0] = (bx0 * vv[0]) * si
    rf = bx1 * vv
    rf[:n - 1] += bx0 * vv[1:]
    torch.mul(rf, si, out=z[1:])
    zs = z.unbind(0)
    tmp = torch.empty_like(zs[0])
    for f in range(1, n + 1):
        torch.mul(ll[f - 1], zs[f - 1], out=tmp)
        zs[f].sub_(tmp)
    F = z * dd
    Fs = F.unbind(0)
    for e in range(n - 1, -1, -1):
        torch.mul(ll[e], Fs[e + 1], out=tmp)
        Fs[e].sub_(tmp)
    contrib = bx0 * F[:n] + bx1 * F[1:]
    return acc + contrib.movedim(0, axis)


def row_stride(n: int, tl: int, ch: int) -> int:
    """Row stride (values) of the tiled kernels' shared-memory rows for lines
    of ``n`` cells, ``tl`` lines and ``ch`` chunks per line: ``tile_layout``
    of ``csrc/fused_rows.cu`` and ``csrc/fused_ho_rows.cu`` (chunk length
    odd, the stride padded against bank conflicts)."""
    ln = -(-(n + 1) // ch)
    ln += 1 - ln % 2
    want = (ch * ln) % 32 if ch < 32 else (32 // tl if tl < 32 else 1)
    return ch * ln + (want - ch * ln) % 32


def rows_smem(n: int, tl: int, ch: int, elem_bytes: int, rows: int = 4) -> int:
    """Shared memory bytes of one tile of a tiled kernel: ``rows`` rows per
    line (the v/z/F, dm, l and acc rows of ``fused_rows.cu``), plus the
    tile's line offsets."""
    return 8 * tl + rows * tl * row_stride(n, tl, ch) * elem_bytes


def rows_tile(lines: int, n: int, dtype):
    """(lines per block, chunks per line) of the tiled kernel for a y or x
    launch of ``lines`` lines (per group) of ``n`` cells.  A fixed rule on the
    shape: ``ROWS_LINES[dtype]`` lines of ``ROWS_CHUNKS`` chunks, the lines
    halved while the tile exceeds the card's shared memory (down to one line
    per block; beyond that the launch is refused and raises).  The tiled
    kernel serves every shape: in chip_smoke.py [3] it measured faster than
    the thread-per-line kernel it replaced at each one swept (PERF.md)."""
    return fit_tile(ROWS_LINES[dtype], ROWS_CHUNKS, n, 4, dtype)


def fit_tile(tl: int, ch: int, n: int, rows: int, dtype):
    """(lines, chunks) from ``tl`` x ``ch``, the lines halved while a tile of
    ``rows`` rows of ``n``-cell lines exceeds the card's shared memory; the
    chunks doubled where that would leave a block under one warp (the chunk
    scan shuffles across a full warp).  Stops at one line per block: a tile
    that does not fit even then is refused at launch, and the wrapper raises."""
    elem = torch.finfo(dtype).bits // 8
    while tl > 1 and rows_smem(n, tl, ch, elem, rows) > SMEM_PER_BLOCK:
        tl //= 2
        if tl * ch < 32:
            ch *= 2
    return tl, ch


def z_smem(n: int, tl: int, ch: int, elem_bytes: int) -> int:
    """Shared memory bytes of one tile of the z kernels: the v/z/F, dm, l and
    acc rows of ``n + 1`` faces by ``tl`` lines, and the chunks' four carry
    rows (``csrc/fused_z_rows.cu``)."""
    return (4 * (n + 1) + 4 * ch) * tl * elem_bytes


def z_tile(lines: int, n: int, dtype):
    """(lines per block, chunks per line) of the z kernels for a launch of
    ``lines`` lines (per group) of ``n`` cells: ``Z_LINES`` x ``Z_CHUNKS``,
    the lines halved while the tile exceeds the card's shared memory, down to
    the kernels' least of 8 (then the launch is refused and raises)."""
    tl, ch = Z_LINES, Z_CHUNKS
    while tl > 8 and z_smem(n, tl, ch, torch.finfo(dtype).bits // 8) > SMEM_PER_BLOCK:
        tl //= 2
    return tl, ch


def _check(acc, v, dm, l, dm_shape, l_shape, what, groups=None):
    """Raise on what the kernels do not take.  ``groups`` None: one group's
    flux (every leading dim 1); else a (groups, 1, ..., nz, ny, nx) flux
    whose operands carry the same group count in front."""
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {v.dtype}")
    lead = tuple(v.shape[:-3])
    if groups is None:
        if v.ndim < 3 or any(s != 1 for s in lead):
            raise NotImplementedError(
                f"{what}: v must be one group's (..., nz, ny, nx) grid with unit leading dims, "
                f"got {tuple(v.shape)}")
    elif len(lead) < 1 or any(s != 1 for s in lead[1:]):
        raise NotImplementedError(
            f"{what}: v must be a group-batched (ng, 1, nz, ny, nx) grid, got {tuple(v.shape)}")
    elif lead[0] != groups:
        raise ValueError(f"{what}: v has {lead[0]} groups, its operands {groups}")
    for name, t, shape in (("acc", acc, v.shape), ("dm", dm, dm_shape), ("l", l, l_shape)):
        if t.device != v.device or t.dtype != v.dtype:
            raise TypeError(f"{what}: {name} must be {v.dtype} on {v.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    for name, t in (("acc", acc), ("v", v), ("dm", dm), ("l", l)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch_z(acc, v, dm, l, n, bx0, bx1, si, key, groups=None):
    """The z kernels (K1, its batch): the strides are implied, every line's
    cells and faces at b + f*lines (lines = ny*nx)."""
    lines = v.numel() // n // (groups or 1)
    tile = z_tile(lines, n, v.dtype)
    lib = cuda_lib.library()
    fn = lib.neutfem_fused_z_rows_f32 if v.dtype == torch.float32 else lib.neutfem_fused_z_rows_f64
    err = fn(acc.data_ptr(), v.data_ptr(), dm.data_ptr(), l.data_ptr(), n, lines, groups or 0,
             *tile, float(bx0), float(bx1), float(si),
             torch.cuda.current_stream(v.device).cuda_stream)
    cuda_lib.check(err, f"fused Schur direction {key} (tiled kernel, tile {tile}, n {n})")
    tracing.count(f"fused.{key}_rows")
    return acc


def _launch_rows(acc, v, dm, l, n, inner, outer_stride, cell_stride, bx0, bx1, si, key,
                 groups=None):
    lines = v.numel() // n // (groups or 1)
    tile = rows_tile(lines, n, v.dtype)
    lib = cuda_lib.library()
    f32 = v.dtype == torch.float32
    ptrs = (acc.data_ptr(), v.data_ptr(), dm.data_ptr(), l.data_ptr())
    rest = (int(cell_stride == 1), *tile, float(bx0), float(bx1), float(si),
            torch.cuda.current_stream(v.device).cuda_stream)
    if groups is None:
        fn = lib.neutfem_fused_rows_f32 if f32 else lib.neutfem_fused_rows_f64
        err = fn(*ptrs, n, lines, inner, outer_stride, cell_stride, *rest)
    else:
        fn = lib.neutfem_fused_rows_batched_f32 if f32 else lib.neutfem_fused_rows_batched_f64
        err = fn(*ptrs, n, lines, groups, inner, outer_stride, cell_stride,
                 math.prod(v.shape[-3:]), *rest)
    cuda_lib.check(err, f"fused Schur direction {key} (tiled kernel, tile {tile}, n {n})")
    tracing.count(f"fused.{key}_rows")
    return acc


def _dispatch(acc, v, dm, l, dm_shape, l_shape, to_natural, axis, strides, bx0, bx1, si,
              key, groups=None):
    """``dm_shape`` / ``l_shape``: one group's operand shapes; with ``groups``
    the operands carry that many groups in front.  ``strides``: the y / x
    lines' (inner, outer_stride, cell_stride); the z kernels imply theirs."""
    what = f"fused_schur_{key}"
    if v.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{what}: no kernel for device {v.device}")
    if groups is not None:
        dm_shape, l_shape = (groups, *dm_shape), (groups, *l_shape)
    _check(acc, v, dm, l, dm_shape, l_shape, what, groups)
    if v.device.type == "cpu":
        dm_nat, l_nat = to_natural(dm, l)
        if groups is not None:  # (ng, ...) -> (ng, 1, ..., face grid) against v
            ones = (1,) * (v.ndim - 4)
            dm_nat = dm_nat.reshape(groups, *ones, *dm_nat.shape[-3:])
            l_nat = l_nat.reshape(groups, *ones, *l_nat.shape[-3:])
        acc.copy_(fused_dir_plain(acc, v, dm_nat, l_nat, axis, bx0, bx1, si))
        return acc
    n = v.shape[axis]
    if n < 1:
        raise ValueError(f"{what}: empty solve axis")
    if key.startswith("z"):
        return _launch_z(acc, v, dm, l, n, bx0, bx1, si, key, groups)
    return _launch_rows(acc, v, dm, l, n, *strides, bx0, bx1, si, key, groups)


def _z(acc, v, dm, l, bx0, bx1, si, groups):
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dm, l, (nz + 1, ny, nx), (nz, ny, nx),
        # lines (y, x) = the whole plane, cells step by ny*nx: _launch_z's layout
        lambda d_, l_: (d_, l_), -3, None, bx0, bx1, si,
        "z" if groups is None else "z_batched", groups)


def _y(acc, v, dmT, lT, bx0, bx1, si, groups):
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, (ny + 1, nz, nx), (ny, nz, nx),
        lambda d_, l_: (d_.movedim(-3, -2), l_.movedim(-3, -2)), -2,
        # lines (z, x): b = z*nx + x, cells at z*ny*nx + x + e*nx
        (nx, ny * nx, nx), bx0, bx1, si, "y" if groups is None else "y_batched", groups)


def _x(acc, v, dmT, lT, bx0, bx1, si, groups):
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, (nx + 1, nz * ny), (nx, nz * ny),
        lambda d_, l_: (d_.transpose(-1, -2).reshape(*d_.shape[:-2], nz, ny, nx + 1),
                        l_.transpose(-1, -2).reshape(*l_.shape[:-2], nz, ny, nx)), -1,
        # lines (z, y): b = z*ny + y, cells at b*nx + e
        (1, nx, 1), bx0, bx1, si, "x" if groups is None else "x_batched", groups)


def fused_schur_z(acc, v, dm, l, bx0: float, bx1: float, si: float):
    """acc += B_z A_z^{-1} B_z^T v (K1, the tiled kernel), in place.
    dm (nz+1, ny, nx), l (nz, ny, nx)."""
    return _z(acc, v, dm, l, bx0, bx1, si, None)


def fused_schur_y_pre(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_y A_y^{-1} B_y^T v (K2, the tiled kernel), in place.
    dmT (ny+1, nz, nx), lT (ny, nz, nx)."""
    return _y(acc, v, dmT, lT, bx0, bx1, si, None)


def fused_schur_x_pre(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_x A_x^{-1} B_x^T v (K3, the tiled kernel), in place.
    dmT (nx+1, nz*ny), lT (nx, nz*ny)."""
    return _x(acc, v, dmT, lT, bx0, bx1, si, None)


def fused_schur_z_batched(acc, v, dm, l, bx0: float, bx1: float, si: float):
    """acc += B_z A_z^{-1} B_z^T v for every group (K1 with batch ng, the
    batched tiled kernel), in place.
    v (ng, 1, nz, ny, nx); dm (ng, nz+1, ny, nx), l (ng, nz, ny, nx)."""
    return _z(acc, v, dm, l, bx0, bx1, si, dm.shape[0])


def fused_schur_y_batched(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_y A_y^{-1} B_y^T v for every group (K5, the batched tiled
    kernel), in place.  v (ng, 1, nz, ny, nx); dmT (ng, ny+1, nz, nx), lT (ng, ny, nz, nx)."""
    return _y(acc, v, dmT, lT, bx0, bx1, si, dmT.shape[0])


def fused_schur_x_batched(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_x A_x^{-1} B_x^T v for every group (K5, the batched tiled
    kernel), in place.  v (ng, 1, nz, ny, nx); dmT (ng, nx+1, nz*ny), lT (ng, nx, nz*ny)."""
    return _x(acc, v, dmT, lT, bx0, bx1, si, dmT.shape[0])
