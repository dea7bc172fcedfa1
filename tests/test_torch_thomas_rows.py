"""The tiled Thomas solve of csrc/thomas_rows.cu (K4), transcribed in plain
PyTorch, against ``thomas_solve_plain`` and the JAX package's
``thomas_solve(..., interpret=True)``.

The transcription follows the kernel: its addressing of the flat (outer, n,
inner) operands — a face-major tile of TL neighbouring lines of one slab
where inner > 1 (the z and rows layouts, ``_solve_z`` / ``_solve_rows``), a
line-major tile of TL lines where inner == 1 (the x layout,
``_solve_transpose``) — and its two chunked sweeps with the chunk carries
composed in order (``chunk_scan.thomas``), at tiles and chunk counts that
leave ragged tiles and chunks.  Tolerances: float64 rel 1e-12, float32 rel
1e-5 (the same products summed in another association).  The card tests
(tests/test_torch_gpu.py) hold the kernel itself against
``thomas_solve_plain``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chunk_scan
from neutfem_tpu.ops.pallas_tridiag import thomas_solve as j_thomas_solve
from neutfem_tpu_torch.ops import thomas

torch.set_num_threads(1)

# (shape, axis): the z layout (inner = ny*nx), the rows layout (inner = nx),
# the x layout (inner = 1); the JAX kernel takes z and rows from nx >= 64
LAYOUTS = {"z": ((2, 1, 9, 5, 70), -3), "rows": ((2, 1, 6, 13, 66), -2),
           "x": ((2, 1, 5, 7, 23), -1)}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def tiled(r, d, l, axis, tl, ch):
    """x of the tiled kernel: the operands flat as it reads them, (outer, n,
    inner), one tile at a time: its elements gathered at the kernel's
    offsets, solved by ``chunk_scan.thomas``, scattered back."""
    axis %= r.ndim
    n = r.shape[axis]
    inner = math.prod(r.shape[axis + 1:])
    outer = r.numel() // (n * inner)
    rf, df, lf = r.reshape(-1), d.reshape(-1), l.reshape(-1)
    out = torch.full_like(rf, float("nan"))
    k = torch.arange(n).unsqueeze(1)
    if inner == 1:  # line-major: lines b0.. of (outer, n), contiguous each
        tiles = [(b0 * n, b0 * (n - 1), min(tl, outer - b0)) for b0 in range(0, outer, tl)]
    else:  # face-major: lines b0.. of slab o, element k at k*inner
        tiles = [(o * n * inner + b0, o * (n - 1) * inner + b0, min(tl, inner - b0))
                 for o in range(outer) for b0 in range(0, inner, tl)]
    for xb, lb, live in tiles:
        t = torch.arange(live).unsqueeze(0)
        xi = xb + (t * n + k if inner == 1 else k * inner + t)
        li = lb + (t * (n - 1) + k[:-1] if inner == 1 else k[:-1] * inner + t)
        out[xi] = chunk_scan.thomas(rf[xi], df[xi], lf[li], ch)
    assert bool(torch.isfinite(out).all()), "an element was not covered by any tile"
    return out.reshape(r.shape)


@pytest.fixture(scope="module", params=[(lay, dt) for lay in LAYOUTS
                                        for dt in (torch.float64, torch.float32)],
                ids=lambda p: f"{p[0]}-{str(p[1]).split('.')[1]}")
def case(request):
    """(r, d, l, axis, plain x, JAX x) of one layout and dtype."""
    lay, dtype = request.param
    shape, axis = LAYOUTS[lay]
    lshape = list(shape)
    lshape[axis] -= 1
    rng = np.random.default_rng(11)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    r = rng.standard_normal(shape).astype(np_dt)
    d = rng.uniform(0.3, 0.6, shape).astype(np_dt)
    l = rng.uniform(-0.4, 0.4, lshape).astype(np_dt)
    want = j_thomas_solve(jnp.asarray(r), jnp.asarray(d), jnp.asarray(l), axis, interpret=True)
    assert want is not None, "the JAX kernel declined: the layout no longer engages it"
    T = torch.from_numpy
    plain = thomas.thomas_solve(T(r), T(d), T(l), axis)  # CPU: the plain version
    return T(r), T(d), T(l), axis, plain, torch.from_numpy(np.array(want))


def _rel(got, want):
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


@pytest.mark.parametrize("tl,ch", [(32, 1), (32, 8), (8, 4), (16, 32)])
def test_tiled_thomas_matches_plain_and_jax(case, tl, ch):
    r, d, l, axis, plain, want = case
    got = tiled(r, d, l, axis, tl, ch)
    tol = TOL[r.dtype]
    assert _rel(plain, want) <= tol
    assert _rel(got, plain) <= tol
    assert _rel(got, want) <= tol


def test_plain_thomas_matches_the_dense_solve():
    """thomas_solve_plain against the dense inverse of the factored matrix
    T = L D L^T (unit lower bidiagonal L with l below the diagonal, D =
    1/dinv), float64: rel 1e-12."""
    rng = np.random.default_rng(5)
    n = 17
    r = rng.standard_normal((1, n, 3))
    d = rng.uniform(0.3, 0.6, (1, n, 3))
    l = rng.uniform(-0.4, 0.4, (1, n - 1, 3))
    got = thomas.thomas_solve(*(torch.from_numpy(a) for a in (r, d, l)), -2).numpy()
    for j in range(3):
        L = np.eye(n) + np.diag(l[0, :, j], -1)
        Tm = L @ np.diag(1.0 / d[0, :, j]) @ L.T
        want = np.linalg.solve(Tm, r[0, :, j])
        assert np.max(np.abs(got[0, :, j] - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("n,dtype,line_major", [
    (152, torch.float32, False),   # IAEA-3D 8x8x8 line preconditioner, z
    (77, torch.float32, False),    # compute_current z at 6x6x4
    (115, torch.float32, False),   # compute_current y at 6x6x4
    (115, torch.float32, True),    # compute_current x at 6x6x4
    (77, torch.float64, False),
    (913, torch.float64, True),
])
def test_thomas_tile_fits_the_paths_shapes(n, dtype, line_major):
    """The tile rule keeps K1's 32 lines x 8 chunks at the paths' shapes in
    float32 and halves the lines only where the tile would exceed the card's
    shared memory; the kernel's shared-memory count is the rule's."""
    tl, ch = thomas.thomas_tile(n, dtype, line_major)
    elem = torch.finfo(dtype).bits // 8
    assert thomas.thomas_smem(n, tl, ch, elem, line_major) <= thomas.SMEM_PER_BLOCK
    assert 32 <= tl * ch <= 1024
    if dtype == torch.float32 and n <= 152:
        assert (tl, ch) == (thomas.THOMAS_LINES, thomas.THOMAS_CHUNKS)
    if tl < thomas.THOMAS_LINES:
        assert thomas.thomas_smem(n, 2 * tl, ch, elem, line_major) > thomas.SMEM_PER_BLOCK
    row = (n | 1) if line_major else n  # csrc/thomas_rows.cu: 3 rows + 4*ch pairs per line
    assert thomas.thomas_smem(n, tl, ch, elem, line_major) == (3 * row + 4 * ch) * tl * elem


def test_thomas_tile_at_one_line_per_block():
    """Lines too long for 2 lines per block: one line, 32 chunks (a full
    warp); beyond ~19,000 float32 elements even that is refused at launch."""
    tl, ch = thomas.thomas_tile(15000, torch.float32, False)
    assert (tl, ch) == (1, 32)
    assert thomas.thomas_smem(15000, 1, 32, 4, False) <= thomas.SMEM_PER_BLOCK
    assert thomas.thomas_smem(20000, 1, 32, 4, False) > thomas.SMEM_PER_BLOCK
