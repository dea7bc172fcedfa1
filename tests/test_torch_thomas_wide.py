"""The tiled K4′ of csrc/thomas_wide_rows.cu: the plain version against the
JAX package's ``_solve_y`` in interpret mode, and the kernel's algebra,
transcribed in plain PyTorch, against the plain version.

K4′ serves the solve along axis -2 whose rows are too wide for the TPU's
full-row blocks (``thomas.wide_rows``): compute_current's 2D y solves (ZION
48x48 (2, 1, 1, 913, 912), KOEBERG 32x32 (4, 1, 1, 545, 544)) and the 2D
line preconditioner's (1, 1, ny, nx).  Here KOEBERG's layout at a width of
128 (the least that keeps the JAX dispatch on ``_solve_y``).  The
transcription follows the kernel: a face-major tile of TL neighbouring lines
of one slab of the flat (outer, n, inner) operands, each line in CH chunks of
ceil(n / CH) elements (``chunk_scan.thomas``, carries composed in order), at
the tile ``thomas.wide_tile`` picks and at ragged ones.  Tolerances: float64
rel 1e-12, float32 rel 1e-5.  The card tests (tests/test_torch_gpu.py) hold
the kernel itself against the plain version.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chunk_scan
import neutfem_tpu.ops.pallas_tridiag as j_tridiag
from neutfem_tpu_torch.ops import thomas

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _operands(shape, dtype, seed=7):
    lshape = list(shape)
    lshape[-2] -= 1
    rng = np.random.default_rng(seed)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return (rng.standard_normal(shape).astype(np_dt),
            rng.uniform(0.3, 0.6, shape).astype(np_dt),
            rng.uniform(-0.4, 0.4, lshape).astype(np_dt))


def _rel(got, want):
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def wide(r, d, l, tl, ch):
    """x of the tiled K4′: the operands flat, (outer, n, inner); each tile of
    ``tl`` neighbouring lines of one slab gathered at the kernel's offsets,
    solved in ``ch`` chunks, scattered back."""
    n, inner = r.shape[-2], r.shape[-1]
    outer = r.numel() // (n * inner)
    rf, df, lf = r.reshape(-1), d.reshape(-1), l.reshape(-1)
    out = torch.full_like(rf, float("nan"))
    k = torch.arange(n).unsqueeze(1)
    for o in range(outer):
        for b0 in range(0, inner, tl):
            t = torch.arange(min(tl, inner - b0)).unsqueeze(0)
            xi = o * n * inner + b0 + k * inner + t
            li = o * (n - 1) * inner + b0 + k[:-1] * inner + t
            out[xi] = chunk_scan.thomas(rf[xi], df[xi], lf[li], ch)
    assert bool(torch.isfinite(out).all()), "an element was not covered by any tile"
    return out.reshape(r.shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_matches_jax_solve_y_at_koeberg_layout(dtype, monkeypatch):
    shape = (4, 1, 1, 545, 128)
    assert thomas.wide_rows(shape, -2)
    r, d, l = _operands(shape, dtype)
    calls = []
    real = j_tridiag._solve_y

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(j_tridiag, "_solve_y", spy)
    want = j_tridiag.thomas_solve(jnp.asarray(r), jnp.asarray(d), jnp.asarray(l), -2,
                                  interpret=True)
    assert calls, "the JAX dispatch no longer reaches _solve_y at this layout"
    want = torch.from_numpy(np.array(want))
    T = torch.from_numpy
    got = thomas.thomas_solve(T(r), T(d), T(l), -2)  # CPU: the plain version
    assert _rel(got, want) <= TOL[dtype]
    tl, ch = thomas.wide_tile(545, 4, 128, 132)
    assert _rel(wide(T(r), T(d), T(l), tl, ch), want) <= TOL[dtype]


@pytest.mark.parametrize("shape,tl,ch", [
    ((2, 1, 1, 913, 12), 8, 32),    # ZION's line length, a ragged last tile
    ((2, 1, 1, 913, 10), 4, 64),    # ZION's at a tile of 64 chunks
    ((4, 1, 1, 545, 20), 8, 32),    # KOEBERG's
    ((1, 1, 912, 10), 8, 32),       # the 2D line preconditioner's (1, 1, ny, nx)
    ((3, 1, 1, 100, 9), 16, 16),    # short lines: the last chunks empty
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_algebra_matches_plain(shape, tl, ch, dtype):
    T = torch.from_numpy
    r, d, l = (T(a) for a in _operands(shape, dtype, seed=sum(shape)))
    assert math.ceil(shape[-2] / ch) <= thomas.WIDE_LEN and tl * ch <= thomas.WIDE_THREADS
    plain = thomas.thomas_solve_plain(r, d, l, -2)
    assert _rel(wide(r, d, l, tl, ch), plain) <= TOL[dtype]


def test_wide_tile_fills_the_card_at_the_paths_shapes():
    """32 chunks of at most 29 / 19 faces and 8 lines a block at ZION's and
    KOEBERG's compute_current layouts (228 / 272 blocks on 132 SMs) and at the
    line preconditioner's single slab (114 blocks: the lines stay at 8, whole
    32-byte sectors); the lines halved where a tile would exceed the card's
    shared memory; no tile where one line does not fit."""
    for n, outer, inner, dtype, tile in (
            (913, 2, 912, torch.float32, (8, 32)), (545, 4, 544, torch.float32, (8, 32)),
            (912, 1, 912, torch.float32, (8, 32)), (913, 2, 912, torch.float64, (8, 32)),
            (100, 1, 4096, torch.float32, (16, 16)), (100, 1, 1024, torch.float32, (8, 16)),
            (4096, 1, 4096, torch.float32, (2, 128)), (8192, 1, 4096, torch.float32, (1, 256)),
            (19000, 1, 64, torch.float32, (1, 256)), (4000, 1, 4096, torch.float64, (2, 128))):
        assert thomas.wide_tile(n, outer, inner, 132, dtype) == tile, (n, dtype)
        elem = torch.finfo(dtype).bits // 8
        assert thomas.wide_smem(n, *tile, elem) <= thomas.SMEM_PER_BLOCK
        assert tile[0] * tile[1] <= thomas.WIDE_THREADS
    assert thomas.wide_tile(19100, 1, 64, 132) is None
    assert thomas.wide_tile(9600, 1, 64, 132, torch.float64) is None
    for shape in ((2, 1, 1, 913, 912), (4, 1, 1, 545, 544), (1, 1, 912, 912)):
        assert thomas.wide_rows(shape, -2)
