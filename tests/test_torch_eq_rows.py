"""The tiled K7 kernel (csrc/fused_eq_rows.cu), its algebra transcribed in
plain PyTorch, against the plain version ``fused_eq_plain`` (through the
wrappers of ``ops/fused_eq.py`` on CPU tensors) and the JAX package's
``fused_schur_{x_eq,z_eq,x_eq2,y_eq2,z_eq2}`` in interpret mode (float64,
CPU), for all five flag sets in their staging layouts: the x variants
line-major (cells of a line contiguous), y solve-axis-major, z at the z
strides.

The transcription follows the kernel step by step on the flat arrays: each
line's cells gathered at cb + e*cell_stride and its faces at b + f*lines;
v = sdi*y (PRE) and ce*y (CE) formed first; the chunked sweeps of
``chunk_scan.chunked`` (pass 1, the Hillis-Steele scan of the warp
shuffles, pass 2); then base + contribution, times sdi (POST), and u
(EMIT_U).  The card tests (tests/test_torch_gpu.py) hold the kernel itself
against the plain version.  Tolerance: rel <= 1e-12 of the contribution
(the same sums in another association); u is sdi*y exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chunk_scan import chunked
from neutfem_tpu.ops import pallas_fused as jpf
from neutfem_tpu_torch.ops import fused, fused_eq

torch.set_num_threads(1)

BX0, BX1, SI = 0.7, -0.9, 0.35
# (nz, ny, nx) at which every JAX eq kernel engages: the eqfold tests' grid,
# and a ragged one (z lines of 9 cells: fewer faces than 32 chunks)
SHAPES = {"even": (8, 64, 64), "ragged": (9, 57, 70)}
KEYS = ("x_eq", "z_eq", "x_eq2", "y_eq2", "z_eq2")
PRE, EMIT_U, CE, POST = 1, 2, 4, 8


def _geometry(key, shape):
    """(axis, n, lines, (inner, outer_stride, cell_stride)) of the wrapper ``key``."""
    nz, ny, nx = shape
    return {"x": (2, nx, nz * ny, (1, nx, 1)),
            "y": (1, ny, nz * nx, (nx, ny * nx, nx)),
            "z": (0, nz, ny * nx, (ny * nx, 0, ny * nx))}[key[0]]


def eq_rows(key, acc, y, sdi, ce, dm, l, shape, ch):
    """The tiled kernel's algebra on flat arrays: (out, u or None)."""
    flags = fused_eq._FLAGS[key]
    _, n, lines, (inner, outer_stride, cell_stride) = _geometry(key, shape)
    b = torch.arange(lines)
    idx = ((b // inner) * outer_stride + b % inner)[None, :] \
        + torch.arange(n)[:, None] * cell_stride  # (n, lines)
    yl, sl = y[idx], sdi[idx]
    base = ce[idx] * yl if flags & CE else acc[idx]
    v = yl * sl if flags & PRE else yl
    zero = v.new_zeros((1, lines))
    lf = l.reshape(n, lines)
    rhs = (BX1 * torch.cat([zero, v]) + BX0 * torch.cat([v, zero])) * SI
    z = chunked(rhs, torch.cat([zero, -lf]), ch, reverse=False)
    F = chunked(z * dm.reshape(n + 1, lines), torch.cat([-lf, zero]), ch, reverse=True)
    o = base + (BX0 * F[:-1] + BX1 * F[1:])
    if flags & POST:
        o = sl * o
    out = torch.empty_like(y)
    out[idx] = o
    if not flags & EMIT_U:
        return out, None
    u = torch.empty_like(y)
    u[idx] = v
    return out, u


def _staged(key, dm, l, shape):
    """The wrapper's staged (dm, l) from the natural face grids."""
    nz, ny, nx = shape
    if key[0] == "x":
        return dm.reshape(-1, nx + 1).T, l.reshape(-1, nx).T
    if key[0] == "y":
        return np.moveaxis(dm, 1, 0), np.moveaxis(l, 1, 0)
    return dm, l


@pytest.fixture(scope="module", params=[(s, k) for s in SHAPES for k in KEYS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """Operands of one wrapper (a pinned first face), the wrapper's plain
    version and the JAX kernel's result."""
    shape_key, key = request.param
    shape = SHAPES[shape_key]
    ax, n, _, _ = _geometry(key, shape)
    rng = np.random.default_rng(23)
    fsh = list(shape)
    fsh[ax] += 1
    dm = rng.uniform(0.2, 0.6, fsh)
    l = rng.uniform(-0.3, 0.3, shape)
    np.moveaxis(dm, ax, 0)[0] = 0.0
    np.moveaxis(l, ax, 0)[0] = 0.0
    y, acc = rng.standard_normal((2, 1, *shape))
    sdi, ce = rng.uniform(0.5, 2.0, (2, 1, *shape))
    dms, ls = (np.ascontiguousarray(a) for a in _staged(key, dm, l, shape))
    T = torch.tensor
    J = jnp.asarray
    wrapper = getattr(fused_eq, f"fused_schur_{key}")
    jfn = getattr(jpf, f"fused_schur_{key}")
    u_plain = u_want = None
    if key.startswith("x"):
        plain = wrapper(T(y), T(sdi), T(ce), T(dms), T(ls), BX0, BX1, SI)
        want = jfn(J(y), J(sdi), J(ce), J(dms), J(ls), BX0, BX1, SI, interpret=True)
        if key == "x_eq":
            (plain, u_plain), (want, u_want) = plain, want
    elif key == "z_eq":
        plain = wrapper(T(acc), T(y), T(dms), T(ls), T(sdi), BX0, BX1, SI)
        want = jfn(J(acc), J(y), J(dms), J(ls), J(sdi), BX0, BX1, SI, interpret=True)
    else:
        plain = wrapper(T(acc), T(y), T(sdi), T(dms), T(ls), BX0, BX1, SI)
        want = jfn(J(acc), J(y), J(sdi), J(dms), J(ls), BX0, BX1, SI, interpret=True)
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    base = ce * y if key.startswith("x") else (sdi * acc if key.startswith("z") else acc)
    ops = [T(a).reshape(-1) for a in (acc, y, sdi, ce, dms, ls)]
    return key, shape, ops, base, (plain.numpy(), np.asarray(want)), (u_plain, u_want)


def _rel(got, want, base):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


@pytest.mark.parametrize("ch", [1, 5, 32])
def test_eq_rows_algebra_matches_plain_and_jax(case, ch):
    """ch 1 is the unchunked recurrence; 5 and 32 cut every line into
    chunks, 32 more chunks than the ragged grid's z lines have faces."""
    key, shape, ops, base, (plain, want), (u_plain, u_want) = case
    out, u = eq_rows(key, *ops, shape, ch)
    got = out.numpy().reshape(plain.shape)
    assert _rel(got, plain, base) <= 1e-12
    assert _rel(got, want, base) <= 1e-12
    if key == "x_eq":
        u = u.numpy().reshape(plain.shape)
        assert np.array_equal(u, u_plain.numpy())  # u = sdi*y, one product
        assert np.array_equal(u, np.asarray(u_want))
    else:
        assert u is None


def test_eq_tile_fits_the_paths_shapes():
    """The tiled K7's tile at the path's lines (IAEA-3D 6x6x4: x / y 114, z 76;
    1x1: 19; 8x8x8: 152) is its z tile on z, rows_tile's on x / y, and fits
    the card's shared memory with its five rows; very long lines halve the
    lines (a block stays a full warp); a line that does not fit at one line
    per block raises."""
    for dtype in (torch.float32, torch.float64):
        elem = torch.finfo(dtype).bits // 8
        for axis, n in ((-1, 114), (-2, 114), (-3, 76), (-1, 19), (-3, 19), (-3, 152)):
            tl, ch = fused_eq.eq_tile(axis, 8664, n, dtype)
            want = ((fused_eq.EQ_Z_LINES, fused_eq.EQ_Z_CHUNKS) if axis == -3
                    else (fused.ROWS_LINES[dtype], fused.ROWS_CHUNKS))
            assert (tl, ch) == want
            assert fused.rows_smem(n, tl, ch, elem, fused_eq.EQ_ROWS) <= fused.SMEM_PER_BLOCK
        for axis in (-1, -2, -3):
            tl, ch = fused_eq.eq_tile(axis, 1, 3000, dtype)
            assert tl >= 1 and 32 <= tl * ch <= 1024 and ch <= 32
            assert fused.rows_smem(3000, tl, ch, elem, fused_eq.EQ_ROWS) <= fused.SMEM_PER_BLOCK
            with pytest.raises(ValueError, match="shared memory"):
                fused_eq.eq_tile(axis, 1, 20000, dtype)
