"""The chunked recurrence of the tiled K2 / K3 kernel (csrc/fused_rows.cu),
transcribed in plain PyTorch, against the plain version ``fused_dir_plain``
and the JAX package's ``fused_schur_y_pre`` / ``fused_schur_x_pre`` in
interpret mode (float64, CPU); its group-batched form (K5), with each
group's base offsets applied to the flat staged arrays as the batched kernel
addresses them, against ``fused_dir_plain`` and the JAX package's
``fused_schur_dir`` on a group-batched flux (``_fused_y`` / ``_fused_x``);
and the z kernels of csrc/fused_z_rows.cu (K1, one group and its group
batch: every line at b + f*lines, the chunk carries composed in order), on
the flat arrays, against ``fused_dir_plain`` and ``fused_schur_dir`` on
axis -3 (``_fused_z``).

The transcription follows the kernel step by step (``chunk_scan.chunked``:
chunks, pass 1, the Hillis-Steele scan of the warp shuffles, pass 2):
forward for z, then backward for F, then the divergence.  The card tests
(tests/test_torch_gpu.py) hold the kernels themselves against
``fused_dir_plain``.  Tolerance: rel <= 1e-12 (the same sums in another
association).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chunk_scan import chunked, scan, serial
from neutfem_tpu.ops.pallas_fused import fused_schur_dir, fused_schur_x_pre, fused_schur_y_pre
from neutfem_tpu_torch.ops import fused

torch.set_num_threads(1)

BX0, BX1, SI = 0.7, -0.9, 0.35
SHAPES = {"2d": (1, 515, 45), "3d": (8, 64, 64)}  # (nz, ny, nx)


def chunked_dir(acc, v, dm, l, ch, carries=scan):
    """acc + B A^{-1} B^T v on solve-axis-major (n, lines) v and acc, dm
    (n+1, lines), l (n, lines), with ``ch`` chunks per line, their carries
    from ``carries`` (``chunk_scan.scan`` or ``serial``)."""
    zero = v.new_zeros((1, v.shape[1]))
    b = (BX1 * torch.cat([zero, v]) + BX0 * torch.cat([v, zero])) * SI
    z = chunked(b, torch.cat([zero, -l]), ch, False, carries)
    F = chunked(z * dm, torch.cat([-l, zero]), ch, True, carries)
    return acc + (BX0 * F[:-1] + BX1 * F[1:])


@pytest.fixture(scope="module", params=[(s, d) for s in SHAPES for d in ("y", "x")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """Operands of one direction, staged as the wrappers take them, the
    plain version's result and the JAX kernel's (None where it declines:
    the y kernel needs nz >= 4)."""
    shape_key, d = request.param
    nz, ny, nx = SHAPES[shape_key]
    n, lines = (ny, nz * nx) if d == "y" else (nx, nz * ny)
    rng = np.random.default_rng(7)
    v, acc = rng.standard_normal((2, 1, nz, ny, nx))
    dmT = rng.uniform(0.2, 0.6, (n + 1, lines))
    lT = rng.uniform(-0.3, 0.3, (n, lines))
    dmT[0] = 0.0  # a pinned first face (zero current: l = dm = 0 there)
    lT[0] = 0.0
    if d == "y":
        staged = (dmT.reshape(n + 1, nz, nx), lT.reshape(n, nz, nx))
        jfn, wrapper = fused_schur_y_pre, fused.fused_schur_y_pre
        lines_of = lambda a: a.reshape(nz, ny, nx).transpose(1, 0, 2).reshape(ny, -1)  # noqa: E731
        from_lines = lambda a: a.reshape(ny, nz, nx).transpose(1, 0, 2)  # noqa: E731
    else:
        staged = (dmT, lT)
        jfn, wrapper = fused_schur_x_pre, fused.fused_schur_x_pre
        lines_of = lambda a: a.reshape(-1, nx).T  # noqa: E731
        from_lines = lambda a: a.T.reshape(nz, ny, nx)  # noqa: E731
    plain = wrapper(torch.tensor(acc), torch.tensor(v),
                    *(torch.tensor(np.ascontiguousarray(a)) for a in staged), BX0, BX1, SI)
    want = jfn(jnp.asarray(acc), jnp.asarray(v), *(jnp.asarray(a) for a in staged),
               BX0, BX1, SI, interpret=True)
    assert (want is None) == (d == "y" and nz < 4), "the JAX kernel's gate moved"
    T = torch.tensor
    ops = (T(np.ascontiguousarray(lines_of(acc))), T(np.ascontiguousarray(lines_of(v))),
           T(dmT), T(lT))
    return ops, from_lines, plain.numpy()[0], None if want is None else np.asarray(want)[0]


def _rel(got, want, base):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


@pytest.mark.parametrize("ch", [1, 5, 8, 32, 128])
def test_chunked_recurrence_matches_plain_and_jax(case, ch):
    """ch 1 is the unchunked recurrence; 8 and 32 divide n = 64 (3d) and
    not n = 45 or 515 (2d), 5 divides none; 128 leaves chunks empty."""
    (acc, v, dm, l), from_lines, plain, want = case
    got = from_lines(chunked_dir(acc, v, dm, l, ch).numpy())
    acc_nat = from_lines(acc.numpy())
    assert _rel(got, plain, acc_nat) <= 1e-12
    if want is not None:
        assert _rel(got, want, acc_nat) <= 1e-12


def test_rows_tile_fits_the_paths_shapes():
    """The tiled kernel's tile at the paths' line lengths (ZION 912, KOEBERG
    544, IAEA-3D 6x6x4 114 and 8x8x8 152, IAEA-3D 1x1 19) fits the card's
    shared memory at its full lines per block; very long lines halve it; a
    line no tile holds gets one line per block, which the card refuses."""
    for dtype in (torch.float32, torch.float64):
        elem = torch.finfo(dtype).bits // 8
        for n in (912, 544, 152, 114, 19, 1):
            tl, ch = fused.rows_tile(912, n, dtype)
            assert (tl, ch) == (fused.ROWS_LINES[dtype], fused.ROWS_CHUNKS)
            assert fused.rows_smem(n, tl, ch, elem) <= fused.SMEM_PER_BLOCK
        tl, ch = fused.rows_tile(1, 4000, dtype)
        assert 1 <= tl < fused.ROWS_LINES[dtype]
        assert fused.rows_smem(4000, tl, ch, elem) <= fused.SMEM_PER_BLOCK
        assert fused.rows_tile(1, 25000, dtype)[0] == 1
        assert fused.rows_smem(25000, 1, ch, elem) > fused.SMEM_PER_BLOCK


# group-batched shapes (ng, (nz, ny, nx)) per direction at which the JAX
# kernels engage: two groups, and a ragged three
BATCHED = {"y": [(2, (4, 9, 128)), (3, (5, 7, 128))], "x": [(2, (4, 64, 9)), (3, (5, 37, 11))],
           "z": [(2, (4, 8, 64)), (3, (5, 9, 70))]}
# the z wrappers' (inner, outer_stride, cell_stride): lines are the (y, x)
# plane, a line's cells step by ny*nx (ops/fused.py)
Z_STRIDES = lambda nz, ny, nx: (ny * nx, 0, ny * nx)  # noqa: E731


def batched_chunked_dir(acc, v, dm, l, ng, n, lines, strides, ch, carries=scan):
    """The batched kernels' tile algebra on flat arrays: group g's cells at
    g*group_stride + cb + e*cell_stride (cb = (b // inner)*outer_stride +
    b % inner), its dm at g*(n+1)*lines + f*lines + b, its l at g*n*lines +
    f*lines + b."""
    inner, outer_stride, cell_stride = strides
    group_stride = acc.numel() // ng
    b = torch.arange(lines)
    cells = ((b // inner) * outer_stride + b % inner)[None, :] \
        + torch.arange(n)[:, None] * cell_stride  # (n, lines)
    out = acc.clone()
    for g in range(ng):
        idx = g * group_stride + cells
        dg = dm[g * (n + 1) * lines:(g + 1) * (n + 1) * lines].reshape(n + 1, lines)
        lg = l[g * n * lines:(g + 1) * n * lines].reshape(n, lines)
        out[idx] = chunked_dir(acc[idx], v[idx], dg, lg, ch, carries)
    return out


@pytest.mark.parametrize("d,ng,shape", [(d, ng, s) for d in BATCHED for ng, s in BATCHED[d]],
                         ids=lambda p: str(p))
@pytest.mark.parametrize("ch", [1, 5, 32])
def test_batched_chunked_recurrence_matches_plain_and_jax(d, ng, shape, ch):
    """K5 (y, x) and K1's batch (z, carries composed in order): the batched
    tile algebra, with per-group offsets into the flat staged operands,
    against the batched wrapper's plain version and the JAX package's
    group-batched kernel in interpret mode (ch 32 leaves chunks empty on the
    z lines of 5 cells)."""
    nz, ny, nx = shape
    ax = {"z": 0, "y": 1, "x": 2}[d]
    n = shape[ax]
    rng = np.random.default_rng(11 + ng)
    fsh = [nz, ny, nx]
    fsh[ax] += 1
    dm = rng.uniform(0.2, 0.6, (ng, *fsh))
    ll = rng.uniform(-0.3, 0.3, (ng, *shape))
    np.moveaxis(dm, ax + 1, 0)[0] = 0.0  # a pinned first face in every group
    np.moveaxis(ll, ax + 1, 0)[0] = 0.0
    v, acc = rng.standard_normal((2, ng, 1, *shape))
    if d == "z":  # (ng, nz+1, ny, nx) as they are, lines b = y*nx + x
        staged = (dm, ll)
        strides, lines = Z_STRIDES(nz, ny, nx), ny * nx
        wrapper = fused.fused_schur_z_batched
    elif d == "y":  # (ng, ny+1, nz, nx), lines b = z*nx + x
        staged = (np.moveaxis(dm, 2, 1), np.moveaxis(ll, 2, 1))
        strides, lines = (nx, ny * nx, nx), nz * nx
        wrapper = fused.fused_schur_y_batched
    else:  # (ng, nx+1, nz*ny), lines b = z*ny + y
        staged = (np.swapaxes(dm.reshape(ng, -1, nx + 1), 1, 2),
                  np.swapaxes(ll.reshape(ng, -1, nx), 1, 2))
        strides, lines = (1, nx, 1), nz * ny
        wrapper = fused.fused_schur_x_batched
    staged = [torch.tensor(np.ascontiguousarray(a)) for a in staged]
    plain = wrapper(torch.tensor(acc), torch.tensor(v), *staged, BX0, BX1, SI).numpy()
    want = fused_schur_dir(jnp.asarray(acc), jnp.asarray(v), jnp.asarray(dm[:, None]),
                           jnp.asarray(ll[:, None]), ax - 3, BX0, BX1, SI, interpret=True)
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    got = batched_chunked_dir(torch.tensor(acc).reshape(-1), torch.tensor(v).reshape(-1),
                              staged[0].reshape(-1), staged[1].reshape(-1), ng, n, lines,
                              strides, ch, serial if d == "z" else scan
                              ).numpy().reshape(acc.shape)
    assert _rel(got, plain, acc) <= 1e-12
    assert _rel(got, np.asarray(want), acc) <= 1e-12


# one-group z shapes (nz, ny, nx) at which the JAX z kernel engages (n >= 4,
# nx >= 64, ny*nx >= 512): a cubic grid, and a ragged one whose lines are
# shorter than some chunk counts (n + 1 = 6 faces < 8, 32)
Z_SHAPES = {"cubic": (64, 64, 64), "ragged": (5, 33, 70)}


@pytest.fixture(scope="module", params=sorted(Z_SHAPES))
def z_case(request):
    """One group's z operands, the z wrapper's plain version and the JAX
    kernel's result, with a pinned first face (l = dm = 0 there)."""
    nz, ny, nx = shape = Z_SHAPES[request.param]
    rng = np.random.default_rng(17)
    v, acc = rng.standard_normal((2, 1, *shape))
    dm = rng.uniform(0.2, 0.6, (nz + 1, ny, nx))
    ll = rng.uniform(-0.3, 0.3, shape)
    dm[0] = 0.0
    ll[0] = 0.0
    T = torch.tensor
    plain = fused.fused_schur_z(T(acc), T(v), T(dm), T(ll), BX0, BX1, SI).numpy()
    want = fused_schur_dir(jnp.asarray(acc), jnp.asarray(v), jnp.asarray(dm), jnp.asarray(ll),
                           -3, BX0, BX1, SI, interpret=True)
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    return shape, (acc, v, dm, ll), plain, np.asarray(want)


@pytest.mark.parametrize("ch", [1, 5, 8, 32])
def test_z_chunked_recurrence_matches_plain_and_jax(z_case, ch):
    """K1 on z lines: the z kernel's algebra on the flat arrays (every cell
    and face of line b at b + f*lines), one group, the chunk carries
    composed in order."""
    (nz, ny, nx), (acc, v, dm, ll), plain, want = z_case
    got = batched_chunked_dir(torch.tensor(acc).reshape(-1), torch.tensor(v).reshape(-1),
                              torch.tensor(dm).reshape(-1), torch.tensor(ll).reshape(-1), 1, nz,
                              ny * nx, Z_STRIDES(nz, ny, nx), ch, serial
                              ).numpy().reshape(acc.shape)
    assert _rel(got, plain, acc) <= 1e-12
    assert _rel(got, want, acc) <= 1e-12


def test_z_tile_fits_the_paths_shapes():
    """The z kernels' tile at the paths' z lines (IAEA-3D 6x6x4 76, 8x8x8 152,
    1x1 19; the 2D cores' single cell) fits the card's shared memory at its
    full lines per block, whole warps; very long z lines halve the lines,
    down to 8; a line no tile of 8 holds is refused at launch."""
    for dtype in (torch.float32, torch.float64):
        elem = torch.finfo(dtype).bits // 8
        for n in (152, 76, 19, 1):
            tl, ch = fused.z_tile(23104, n, dtype)
            assert (tl, ch) == (fused.Z_LINES, fused.Z_CHUNKS)
            assert fused.z_smem(n, tl, ch, elem) <= fused.SMEM_PER_BLOCK
            assert (tl * ch) % 32 == 0 and tl * ch <= 1024
        tl, ch = fused.z_tile(1, 600, dtype)
        assert 8 <= tl < fused.Z_LINES and (tl * ch) % 32 == 0
        assert fused.z_smem(600, tl, ch, elem) <= fused.SMEM_PER_BLOCK
        tl, ch = fused.z_tile(1, 25000, dtype)
        assert tl == 8 and fused.z_smem(25000, tl, ch, elem) > fused.SMEM_PER_BLOCK
