"""Equilibration-folded RT0 Schur directions — K7.

Port of the five equilibration-folded kernels of ``neutfem_tpu/ops/pallas_fused.py``
(``fused_schur_x_eq``, ``fused_schur_z_eq``, ``fused_schur_x_eq2``,
``fused_schur_y_eq2``, ``fused_schur_z_eq2``), which
``ops/apply.equilibrated_schur_matvec`` chains into the CG's matvec
sdi * S(sdi * y) (sdi = diag(S)^-1/2, ce = C * sdi) under ``NEUTFEM_EQFOLD``:

* mode 1: ``fused_schur_x_eq`` -> (ce*y + X(u), u = sdi*y); K2
  (``ops/fused.fused_schur_y_pre``) adds Y(u); ``fused_schur_z_eq`` ->
  sdi*(acc + Z(u));
* mode 2: ``fused_schur_x_eq2`` -> ce*y + X(sdi*y); ``fused_schur_y_eq2`` ->
  acc + Y(sdi*y); ``fused_schur_z_eq2`` -> sdi*(acc + Z(sdi*y)),

with X, Y, Z the direction operators B_d A_d^{-1} B_d^T of ``ops/fused.py``.
On a CUDA tensor each wrapper launches the tiled ``fused_eq_rows_kernel`` of
``csrc/fused_eq_rows.cu`` (one template, a flag set per wrapper; a tile of
lines per block, each line cut into chunks, at the tile ``eq_tile`` picks);
on a CPU tensor it runs its plain version, composed from
``fused.fused_dir_plain`` and elementwise products.  A CUDA tensor the
kernel does not take, or a tile the card refuses, raises.  A launch counts
under ``tracing``'s ``fused_eq.<key>_rows`` ("fused_eq.x_eq_rows", ...).

Operands (every cell grid one group's (..., nz, ny, nx) with unit leading
dims, float32 or float64): the direction operands in the layouts of
``ops/fused.py`` — z: dm (nz+1, ny, nx), l (nz, ny, nx); y: ``tri_yT_*``
(ny+1 / ny, nz, nx); x: ``tri_xT_*`` (nx+1 / nx, nz*ny).  The x wrappers
return a new tensor (and u); the y and z wrappers UPDATE ``acc`` IN PLACE and
return it, as the TPU kernels alias it to their output.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import cuda_lib
from .fused import ROWS_CHUNKS, ROWS_LINES, SMEM_PER_BLOCK, fit_tile, rows_smem
from .fused import fused_dir_plain

__all__ = ["fused_schur_x_eq", "fused_schur_z_eq", "fused_schur_x_eq2", "fused_schur_y_eq2",
           "fused_schur_z_eq2", "fused_eq_plain", "eq_tile"]

#: Shared-memory rows per line of the tiled kernel: y (then v, z, F), dm, l,
#: acc or ce, sdi (then u).
EQ_ROWS = 5
#: Its tile on z lines (lines per block, chunks per line): the best or within
#: 2% of the best tile of chip_smoke.py [3]'s sweeps of z_eq and z_eq2 at
#: IAEA-3D 6x6x4 (PERF.md).  The x and y lines take ``rows_tile``'s.
EQ_Z_LINES, EQ_Z_CHUNKS = 16, 4

# the kernel's flags (csrc/fused_eq_rows.cu)
_PRE, _EMIT_U, _CE, _POST = 1, 2, 4, 8
_FLAGS = {"x_eq": _PRE | _EMIT_U | _CE, "z_eq": _POST, "x_eq2": _PRE | _CE,
          "y_eq2": _PRE, "z_eq2": _PRE | _POST}


def fused_eq_plain(key, acc, y, sdi, ce, dm, l, axis: int, bx0: float, bx1: float, si: float):
    """Plain PyTorch version of the wrapper ``key`` ("x_eq", ..., "z_eq2") on
    the natural layout (dm (n+1) and l (n) entries along ``axis``, as
    ``fused_dir_plain``): (out, u or None); ``acc`` is not touched (nor read
    by the x variants, which take ``ce``)."""
    flags = _FLAGS[key]
    v = y * sdi if flags & _PRE else y
    out = fused_dir_plain(ce * y if flags & _CE else acc, v, dm, l, axis, bx0, bx1, si)
    return (sdi * out if flags & _POST else out), (v if flags & _EMIT_U else None)


def eq_tile(axis: int, lines: int, n: int, dtype):
    """(lines per block, chunks per line) of the tiled kernel for a launch
    along ``axis`` (-3 z, -2 y, -1 x) of ``lines`` lines of ``n`` cells:
    ``EQ_Z_LINES`` x ``EQ_Z_CHUNKS`` on z, ``rows_tile``'s on y and x, the
    lines halved until its ``EQ_ROWS`` rows fit the card's shared memory.
    Raises where one line does not fit."""
    if axis == -3:
        tl, ch = EQ_Z_LINES, EQ_Z_CHUNKS
    else:
        tl, ch = ROWS_LINES[dtype], ROWS_CHUNKS
    tl, ch = fit_tile(tl, ch, n, EQ_ROWS, dtype)
    if rows_smem(n, tl, ch, torch.finfo(dtype).bits // 8, EQ_ROWS) > SMEM_PER_BLOCK:
        raise ValueError(f"fused_eq: a line of {n} cells does not fit the card's shared memory "
                         f"in {dtype}")
    return tl, ch


def _geometry(axis, shape):
    """(dm shape, l shape, (inner, outer_stride, cell_stride), staged -> natural)
    of one group's operands along ``axis`` (-3 z, -2 y, -1 x)."""
    nz, ny, nx = shape
    if axis == -3:
        return ((nz + 1, ny, nx), (nz, ny, nx), (ny * nx, 0, ny * nx),
                lambda d_, l_: (d_, l_))
    if axis == -2:
        return ((ny + 1, nz, nx), (ny, nz, nx), (nx, ny * nx, nx),
                lambda d_, l_: (d_.movedim(0, 1), l_.movedim(0, 1)))
    return ((nx + 1, nz * ny), (nx, nz * ny), (1, nx, 1),
            lambda d_, l_: (d_.T.reshape(nz, ny, nx + 1), l_.T.reshape(nz, ny, nx)))


def _run(key, axis, acc, y, sdi, ce, dm, l, bx0, bx1, si):
    """Check the operands, then the kernel (CUDA) or the plain version (CPU).
    ``acc`` is the output: updated in place, or new (``ce`` given).  Returns
    (acc, u or None)."""
    what = f"fused_schur_{key}"
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {y.dtype}")
    if y.ndim < 3 or any(s != 1 for s in y.shape[:-3]):
        raise NotImplementedError(f"{what}: y must be one group's (..., nz, ny, nx) grid with "
                                  f"unit leading dims, got {tuple(y.shape)}")
    dm_shape, l_shape, strides, to_natural = _geometry(axis, tuple(y.shape[-3:]))
    named = [("acc", acc, y.shape), ("sdi", sdi, y.shape), ("dm", dm, dm_shape),
             ("l", l, l_shape)] + ([("ce", ce, y.shape)] if ce is not None else [])
    for name, t, shape in named:
        if t.device != y.device or t.dtype != y.dtype:
            raise TypeError(f"{what}: {name} must be {y.dtype} on {y.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not y.is_contiguous():
        raise ValueError(f"{what}: y must be contiguous")
    flags = _FLAGS[key]
    if y.device.type == "cpu":
        out, u = fused_eq_plain(key, acc, y, sdi, ce, *to_natural(dm, l), axis, bx0, bx1, si)
        return acc.copy_(out), u
    if y.device.type != "cuda":
        raise NotImplementedError(f"{what}: no kernel for device {y.device}")
    n = y.shape[axis]
    if n < 1:
        raise ValueError(f"{what}: empty solve axis")
    lines = y.numel() // n
    tile = eq_tile(axis, lines, n, y.dtype)
    u = torch.empty_like(y) if flags & _EMIT_U else None
    lib = cuda_lib.library()
    fn = (lib.neutfem_fused_eq_rows_f32 if y.dtype == torch.float32
          else lib.neutfem_fused_eq_rows_f64)
    err = fn(flags, acc.data_ptr(), y.data_ptr(), sdi.data_ptr(),
             ce.data_ptr() if ce is not None else None, dm.data_ptr(), l.data_ptr(),
             u.data_ptr() if u is not None else None, n, lines, *strides, *tile,
             float(bx0), float(bx1), float(si), torch.cuda.current_stream(y.device).cuda_stream)
    cuda_lib.check(err, f"{what} (tiled kernel, tile {tile}, n {n})")
    tracing.count(f"fused_eq.{key}_rows")
    return acc, u


def fused_schur_x_eq(y, sdi, ce, dmT, lT, bx0: float, bx1: float, si: float):
    """(ce*y + B_x A_x^{-1} B_x^T u, u) with u = sdi*y: the first stage of mode 1."""
    return _run("x_eq", -1, torch.empty_like(y), y, sdi, ce, dmT, lT, bx0, bx1, si)


def fused_schur_z_eq(acc, u, dm, l, sdi, bx0: float, bx1: float, si: float):
    """sdi*(acc + B_z A_z^{-1} B_z^T u), in place: the last stage of mode 1."""
    return _run("z_eq", -3, acc, u, sdi, None, dm, l, bx0, bx1, si)[0]


def fused_schur_x_eq2(y, sdi, ce, dmT, lT, bx0: float, bx1: float, si: float):
    """ce*y + B_x A_x^{-1} B_x^T (sdi*y): the first stage of mode 2."""
    return _run("x_eq2", -1, torch.empty_like(y), y, sdi, ce, dmT, lT, bx0, bx1, si)[0]


def fused_schur_y_eq2(acc, y, sdi, dmT, lT, bx0: float, bx1: float, si: float):
    """acc + B_y A_y^{-1} B_y^T (sdi*y), in place: the second stage of mode 2."""
    return _run("y_eq2", -2, acc, y, sdi, None, dmT, lT, bx0, bx1, si)[0]


def fused_schur_z_eq2(acc, y, sdi, dm, l, bx0: float, bx1: float, si: float):
    """sdi*(acc + B_z A_z^{-1} B_z^T (sdi*y)), in place: the last stage of mode 2."""
    return _run("z_eq2", -3, acc, y, sdi, None, dm, l, bx0, bx1, si)[0]
