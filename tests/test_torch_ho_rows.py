"""The tiled K6 kernel's algebra (csrc/fused_ho_rows.cu), transcribed in plain
PyTorch, against the plain version ``fused_ho_plain`` and the JAX package's
``fused_ho_dir`` in interpret mode (float64, CPU).

The transcription follows the kernel per (transverse mode t, line): the face
rhs rf_f from the K1 longitudinal mode planes that ``kernel_mode_index``
gives t, with the coefficient table read as the kernel reads
``HoTables.packed()``; the forward and backward recurrences chunk by chunk
(``chunk_scan.chunked``: pass 1, the Hillis-Steele scan of the warp
shuffles, pass 2); then the store, which finds (t, l) of every mode plane
from its base-K1 digits and adds the divergence and the bubble term.  K1 = 2
is held to both references on all three axes; K1 = 3 to the plain version
only (an interpret compile at P = 27 costs ~20 s).  The card tests
(tests/test_torch_gpu.py) hold the kernel itself against ``fused_ho_plain``.
Tolerance: rel <= 1e-12 (the same sums in another association).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chunk_scan import chunked
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.ops.pallas_fused_ho import fused_ho_dir
from neutfem_tpu.ops.pallas_fused_ho import ho_coeff_tables as j_tables
from neutfem_tpu_torch import fespace, mesh
from neutfem_tpu_torch.ops import fused_ho

torch.set_num_threads(1)

# (nz, ny, nx) per solve axis: the JAX kernels engage, n = 13, 21, 19 is no
# multiple of any chunk count below, and the line counts are no multiple of 4
SHAPES = {0: (13, 8, 64), 1: (4, 21, 128), 2: (4, 129, 19)}


def _lines(a, axis):
    """(..., nz, ny, nx) -> (..., n, lines), solve-axis-major, lines in the
    kernel's order (z: y*nx + x; y: z*nx + x; x: z*ny + y)."""
    nz, ny, nx = a.shape[-3:]
    lead = a.shape[:-3]
    if axis == 0:
        return a.reshape(*lead, nz, ny * nx)
    if axis == 1:
        return a.movedim(-2, -3).reshape(*lead, ny, nz * nx)
    return a.reshape(*lead, nz * ny, nx).transpose(-1, -2)


def _natural(a, axis, shape):
    """Inverse of ``_lines``."""
    nz, ny, nx = shape
    lead = a.shape[:-2]
    if axis == 0:
        return a.reshape(*lead, nz, ny, nx)
    if axis == 1:
        return a.reshape(*lead, ny, nz, nx).movedim(-3, -2)
    return a.transpose(-1, -2).reshape(*lead, nz, ny, nx)


def tiled_ho_dir(acc, v, dm, l, alpha, tab, K1, axis, ch):
    """The kernel's algebra on solve-axis-major (P, n, lines) v and acc, dm
    (n+1, lines), l and alpha (n, lines), the packed table (T, 4 K1 + K1^2),
    ``ch`` chunks per (t, line)."""
    P, n, lines = v.shape
    T = K1 * K1
    lstride = K1 ** (2 - axis)
    planes = fused_ho.kernel_mode_index(K1, axis)  # (T, K1): mode plane of (t, l)
    bs0, bs1 = tab[:, :K1], tab[:, K1:2 * K1]
    vt = v[torch.as_tensor(planes.reshape(-1))].reshape(T, K1, n, lines)
    zero = v.new_zeros((T, K1, 1, lines))
    prev, cur = torch.cat([zero, vt], 2), torch.cat([vt, zero], 2)  # v_{f-1}, v_f
    rf = torch.zeros((n + 1, T, lines), dtype=v.dtype)
    for i in range(K1):  # the kernel's order: the bxs1 terms, then the bxs0 terms
        rf += bs1[None, :, i, None] * prev[:, i].transpose(0, 1)
    for i in range(K1):
        rf += bs0[None, :, i, None] * cur[:, i].transpose(0, 1)
    zero = v.new_zeros((1, lines))
    fwd = torch.cat([zero, -l]).unsqueeze(1).expand(n + 1, T, lines)
    z = chunked(rf.reshape(n + 1, -1), fwd.reshape(n + 1, -1), ch, reverse=False)
    bwd = torch.cat([-l, zero]).unsqueeze(1).expand(n + 1, T, lines).reshape(n + 1, -1)
    F = chunked(z * dm.repeat(1, T), bwd, ch, reverse=True).reshape(n + 1, T, lines)
    out = acc.clone()
    for p in range(P):
        d = (p % K1, (p // K1) % K1, p // T)
        lpow = 2 - axis
        lm = d[lpow]
        lo, hi = [d[i] for i in range(3) if i != lpow]
        t = lo + K1 * hi
        row = tab[t]
        qv = torch.zeros((n, lines), dtype=v.dtype)
        for j in range(K1):
            qv += row[4 * K1 + lm * K1 + j] * v[p + (j - lm) * lstride]
        out[p] = acc[p] + (row[2 * K1 + lm] * F[:-1, t] + row[3 * K1 + lm] * F[1:, t]
                           + qv / alpha)
    return out


def _operands(k, axis, seed):
    """Port and JAX tables of a random mesh's direction on ``axis``, the
    staged operands (two pinned faces: the first and one inside) in the
    port's layouts and in the JAX kernels' (x lane-packed), v and acc."""
    shape = SHAPES[axis]
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, s))]) for s in (nx, ny, nz)]
    tfes = fespace.make_fespace(mesh.CartesianMesh.from_breaks(*breaks), k, k)
    di = [d for d in tfes.dirs if d.axis == axis][0]
    tabs = fused_ho.ho_tables(tfes, di)
    n = shape[axis]
    lines = nz * ny * nx // n
    dm = rng.uniform(0.2, 0.6, (n + 1, lines))
    l = rng.uniform(-0.3, 0.3, (n, lines))
    alpha = rng.uniform(0.5, 2.0, (n, lines))
    for f in {0, n // 2}:
        dm[f] = 0.0
        l[f] = 0.0
    v, acc = rng.standard_normal((2, 1, tfes.P, nz, ny, nx))
    jax_ops = None
    if k == 1:
        jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), k, k)
        jdi = [d for d in jfes.dirs if d.axis == axis][0]
        if axis == 2:  # (rows, nz*ny) -> lane-packed (rows, nz*wy); dead lanes alpha = 1
            wy = -(-ny // 128) * 128

            def pack(a, fill):
                out = np.full((a.shape[0], nz, wy), fill)
                out[:, :, :ny] = a.reshape(a.shape[0], nz, ny)
                return out.reshape(a.shape[0], nz * wy)

            jops = (pack(dm, 0.0), pack(l, 0.0), pack(alpha, 1.0))
        else:
            rest = [s for i, s in enumerate(shape) if i != axis]
            jops = tuple(a.reshape(a.shape[0], *rest) for a in (dm, l, alpha))
        jax_ops = (jfes, jdi, jops, j_tables(jfes, jdi))
    return tabs, dm, l, alpha, v, acc, jax_ops


@pytest.fixture(scope="module", params=[(k, axis) for k in (1, 2) for axis in (0, 1, 2)],
                ids=lambda p: f"k{p[0]}-{'zyx'[p[1]]}")
def case(request):
    """One direction's operands, the plain version's result and, at k = 1, the
    JAX kernel's in interpret mode."""
    k, axis = request.param
    tabs, dm, l, alpha, v, acc, jax_ops = _operands(k, axis, 20 + 3 * k + axis)
    shape = SHAPES[axis]
    T = torch.tensor
    rest = [s for i, s in enumerate(shape) if i != axis]
    staged = {0: lambda a: T(a.reshape(a.shape[0], *rest)),
              1: lambda a: T(a.reshape(a.shape[0], *rest)),
              2: T}[axis]
    wrapper = (fused_ho.fused_ho_z, fused_ho.fused_ho_y, fused_ho.fused_ho_x)[axis]
    plain = wrapper(T(acc), T(v), staged(dm), staged(l), staged(alpha), tabs).numpy()
    want = None
    if jax_ops is not None:
        jfes, jdi, jops, jtabs = jax_ops
        want = fused_ho_dir(jfes, jdi, jnp.asarray(acc), jnp.asarray(v),
                            *(jnp.asarray(a) for a in jops), jtabs, interpret=True)
        assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
        want = np.asarray(want)
    ops = (_lines(T(acc[0]), axis), _lines(T(v[0]), axis), T(dm), T(l), T(alpha),
           T(tabs.packed()))
    return k, axis, ops, acc, plain, want


def _rel(got, want, base):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


@pytest.mark.parametrize("ch", [1, 3, 5, 8, 32])
def test_tiled_ho_algebra_matches_plain_and_jax(case, ch):
    """ch 1 is the unchunked recurrence; 3, 5 and 8 divide none of the face
    counts; 32 leaves chunks empty."""
    k, axis, (acc, v, dm, l, alpha, tab), acc_np, plain, want = case
    got = tiled_ho_dir(acc, v, dm, l, alpha, tab, k + 1, axis, ch)
    got = _natural(got, axis, SHAPES[axis]).numpy()[None]
    assert _rel(got, plain, acc_np) <= 1e-12
    if want is not None:
        assert _rel(got, want, acc_np) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K1", [2, 3])
def test_ho_tile_fits_the_paths_shapes(dtype, K1):
    """The tile at the paths' line lengths (IAEA-3D 4x4x2: z 38, y and x 76;
    IAEA-3D 1x1: 19) keeps its full lines per block, fits the card's shared
    memory and meets the launcher's rules (powers of two, a warp holds whole
    lines, modes per block dividing K1^2, at most 1024 threads); very long
    lines shrink it, and a line no tile holds gets one line per block, which
    the card refuses."""
    elem = torch.finfo(dtype).bits // 8

    def legal(tl, ch, tg):
        return (tl & (tl - 1) == 0 and ch & (ch - 1) == 0 and ch <= 32 and tl * ch >= 32
                and (K1 * K1) % tg == 0 and tg * tl * ch <= 1024)

    for n in (19, 38, 76):
        tile = fused_ho.ho_tile(2888, n, K1, dtype)
        assert tile == (fused_ho.HO_LINES, fused_ho.HO_CHUNKS, fused_ho.HO_MODES[K1])
        assert legal(*tile)
        assert fused_ho.ho_smem(n, *tile, K1, elem) <= fused_ho.SMEM_PER_BLOCK
    tile = fused_ho.ho_tile(1, 600, K1, dtype)
    assert legal(*tile) and tile[0] < fused_ho.HO_LINES
    assert fused_ho.ho_smem(600, *tile, K1, elem) <= fused_ho.SMEM_PER_BLOCK
    tile = fused_ho.ho_tile(1, 8000, K1, dtype)
    assert tile == (1, 32, fused_ho.HO_MODES[K1])
    assert fused_ho.ho_smem(8000, *tile, K1, elem) > fused_ho.SMEM_PER_BLOCK
