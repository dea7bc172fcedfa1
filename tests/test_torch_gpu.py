"""Card-only tests of neutfem_tpu_torch's CUDA kernels against their plain versions.

Each test compares one hand-written kernel (the tiled K1 / K2 / K3 kernel and its
group-batched form, K1's batch and K5; the tiled K4, the tiled K4′, the tiled K6,
the tiled K7, the tiled K8 on its three storage forms) with the plain PyTorch version
of the same function, on the card, at a small shape; the last tests hold the CG's
captured blocks (``krylov.CGGraph``) against the eager block loop on the card, then
the facade's paths on the card: the Anderson solve against the CPU, a zero
right-hand side through a captured CG, and the plans of a context that ``set_bc``
replaced freed with it.  They need a CUDA device and skip without one (the decision is made
inside a fixture, at run time).  This file imports neither JAX nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from neutfem_tpu_torch import fespace, mesh
from neutfem_tpu_torch.ops import blockjac, fused, fused_eq, fused_ho, thomas

pytestmark = pytest.mark.gpu

# f64: the kernels and the plain versions run the same recurrence; only FMA
# contraction in the kernels separates them.  f32 likewise, at f32 rounding.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want, base):
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want - base)))


def _operands(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape

    def t(*s, lo=None, hi=None):
        a = rng.uniform(lo, hi, s) if lo is not None else rng.standard_normal(s)
        return torch.as_tensor(a, dtype=dtype, device=device)

    v, acc = t(1, nz, ny, nx), t(1, nz, ny, nx)
    return v, acc, t


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_z_kernel_matches_plain(cuda, dtype):
    nz, ny, nx = 9, 10, 11
    v, acc, t = _operands((nz, ny, nx), dtype, cuda, 0)
    dm, l = t(nz + 1, ny, nx, lo=0.2, hi=0.6), t(nz, ny, nx, lo=-0.3, hi=0.3)
    want = fused.fused_dir_plain(acc, v, dm, l, -3, 0.5, -0.5, 0.25)
    before = dict(fused.LAUNCHES)
    got = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert {k: fused.LAUNCHES[k] - before[k] for k in fused.LAUNCHES} == {
        k: int(k == "z_rows") for k in fused.LAUNCHES}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(76, 114, 114),    # IAEA-3D 6x6x4: 12,996 lines of 76
                                   (152, 152, 152),   # 8x8x8: 23,104 lines of 152
                                   (5, 33, 70),       # ragged: 2,310 lines, 6 faces
                                   (1, 40, 37),       # n = 1
                                   (300, 3, 5)])      # lines fewer than one tile
def test_fused_z_rows_kernel_matches_plain(cuda, dtype, shape):
    """The tiled K1 at the paths' z shapes and ragged ones, two pinned face
    planes (the first and one inside: l = dm = 0)."""
    nz, ny, nx = shape
    v, acc, t = _operands(shape, dtype, cuda, 60)
    dm, l = t(nz + 1, ny, nx, lo=0.2, hi=0.6), t(nz, ny, nx, lo=-0.3, hi=0.3)
    for f in {0, nz // 2}:
        dm[f] = 0.0
        l[f] = 0.0
    want = fused.fused_dir_plain(acc, v, dm, l, -3, 0.5, -0.5, 0.25)
    got = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_z_rows_kernel_with_unaligned_operands(cuda, dtype):
    """Contiguous operands that start one value past a 16-byte boundary: the
    z kernel copies one value at a time there (no 16-byte copies), with the
    same result."""
    nz, ny, nx = shape = (76, 20, 24)
    v, acc, t = _operands(shape, dtype, cuda, 63)
    dm, l = t(nz + 1, ny, nx, lo=0.2, hi=0.6), t(nz, ny, nx, lo=-0.3, hi=0.3)
    want = fused.fused_dir_plain(acc, v, dm, l, -3, 0.5, -0.5, 0.25)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    got = fused.fused_schur_z(shifted(acc), shifted(v), shifted(dm), shifted(l), 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]


def test_fused_z_rows_kernel_is_deterministic(cuda):
    """No atomics: two launches of the tiled K1 agree bit for bit."""
    v, acc, t = _operands((76, 114, 114), torch.float32, cuda, 61)
    dm, l = t(77, 114, 114, lo=0.2, hi=0.6), t(76, 114, 114, lo=-0.3, hi=0.3)
    first = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    second = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_z_rows_kernel_refuses_a_line_too_long(cuda):
    """z lines no tile of 8 lines holds: the card refuses, the wrapper raises
    (no fallback), and nothing is counted."""
    v, acc, t = _operands((25000, 1, 2), torch.float64, cuda, 62)
    dm, l = t(25001, 1, 2, lo=0.2, hi=0.6), t(25000, 1, 2, lo=-0.3, hi=0.3)
    before = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="tiled kernel"):
        fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_y_kernel_matches_plain(cuda, dtype):
    nz, ny, nx = 9, 10, 11
    v, acc, t = _operands((nz, ny, nx), dtype, cuda, 1)
    dmT, lT = t(ny + 1, nz, nx, lo=0.2, hi=0.6), t(ny, nz, nx, lo=-0.3, hi=0.3)
    want = fused.fused_dir_plain(acc, v, dmT.movedim(0, -2), lT.movedim(0, -2), -2,
                                 0.5, -0.5, 0.25)
    got = fused.fused_schur_y_pre(acc.clone(), v, dmT, lT, 0.5, -0.5, 0.25)
    assert _rel(got, want, acc) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_x_kernel_matches_plain(cuda, dtype):
    nz, ny, nx = 9, 10, 11
    v, acc, t = _operands((nz, ny, nx), dtype, cuda, 2)
    dmT, lT = t(nx + 1, nz * ny, lo=0.2, hi=0.6), t(nx, nz * ny, lo=-0.3, hi=0.3)
    want = fused.fused_dir_plain(acc, v, dmT.T.reshape(nz, ny, nx + 1),
                                 lT.T.reshape(nz, ny, nx), -1, 0.5, -0.5, 0.25)
    got = fused.fused_schur_x_pre(acc.clone(), v, dmT, lT, 0.5, -0.5, 0.25)
    assert _rel(got, want, acc) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,axis", [((2, 1, 13, 7, 9), -3), ((2, 1, 13, 7, 9), -2),
                                        ((2, 1, 13, 7, 9), -1)])
def test_thomas_kernel_matches_plain(cuda, dtype, shape, axis):
    rng = np.random.default_rng(3)
    lshape = list(shape)
    lshape[axis] -= 1
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    dinv = torch.as_tensor(rng.uniform(0.3, 0.5, shape), dtype=dtype, device=cuda)
    l = torch.as_tensor(rng.uniform(-0.2, 0.2, lshape), dtype=dtype, device=cuda)
    want = thomas.thomas_solve_plain(rhs, dinv, l, axis)
    got = thomas.thomas_solve(rhs, dinv, l, axis)
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1, 1, 913, 912), (1, 1, 1, 257, 300), (1, 1, 1, 5000, 20)])
def test_thomas_wide_kernel_matches_plain(cuda, dtype, shape):
    """K4′ (the tiled kernel of csrc/thomas_wide_rows.cu) at wide 2D layouts:
    compute_current's at ZION 48x48, a line count that is no multiple of a
    tile's lines, and a few very long lines (256 chunks a line); counted
    under thomas_wide_rows, never under the first K4′ kernel's thomas_y."""
    assert thomas.wide_rows(shape, -2)
    rng = np.random.default_rng(4)
    lshape = list(shape)
    lshape[-2] -= 1
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    dinv = torch.as_tensor(rng.uniform(0.3, 0.5, shape), dtype=dtype, device=cuda)
    l = torch.as_tensor(rng.uniform(-0.4, 0.4, lshape), dtype=dtype, device=cuda)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -2)
    before = dict(thomas.LAUNCHES)
    got = thomas.thomas_solve(rhs, dinv, l, -2)
    torch.cuda.synchronize()
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]
    assert {k: thomas.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "thomas_wide_rows") for k in before}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", ["y", "x"])
def test_fused_2d_kernels_match_plain(cuda, dtype, key):
    """K2 / K3 on a 2D core's (1, 1, ny, nx) grid: few, long lines."""
    nz, ny, nx = 1, 300, 280
    v, acc, t = _operands((nz, ny, nx), dtype, cuda, 5)
    if key == "y":
        dmT, lT = t(ny + 1, nz, nx, lo=0.2, hi=0.6), t(ny, nz, nx, lo=-0.3, hi=0.3)
        want = fused.fused_dir_plain(acc, v, dmT.movedim(0, -2), lT.movedim(0, -2), -2,
                                     0.5, -0.5, 0.25)
        got = fused.fused_schur_y_pre(acc.clone(), v, dmT, lT, 0.5, -0.5, 0.25)
    else:
        dmT, lT = t(nx + 1, nz * ny, lo=0.2, hi=0.6), t(nx, nz * ny, lo=-0.3, hi=0.3)
        want = fused.fused_dir_plain(acc, v, dmT.T.reshape(nz, ny, nx + 1),
                                     lT.T.reshape(nz, ny, nx), -1, 0.5, -0.5, 0.25)
        got = fused.fused_schur_x_pre(acc.clone(), v, dmT, lT, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]


def _rows_operands(key, shape, dtype, device, seed):
    """Staged operands of the one-group y or x wrapper with two pinned face
    planes (l = dm = 0: the first and one inside), and their natural layouts."""
    nz, ny, nx = shape
    n, lines = (ny, nz * nx) if key == "y" else (nx, nz * ny)
    rng = np.random.default_rng(seed)
    dm = rng.uniform(0.2, 0.6, (n + 1, lines))
    l = rng.uniform(-0.3, 0.3, (n, lines))
    for f in {0, n // 2}:
        dm[f] = 0.0
        l[f] = 0.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    v, acc = (t(rng.standard_normal((1, nz, ny, nx))) for _ in range(2))
    if key == "y":
        staged = (dm.reshape(n + 1, nz, nx), l.reshape(n, nz, nx))
        nat = (np.moveaxis(staged[0], 0, 1), np.moveaxis(staged[1], 0, 1))
    else:
        staged = (dm, l)
        nat = (dm.T.reshape(nz, ny, nx + 1), l.T.reshape(nz, ny, nx))
    return v, acc, [t(a) for a in staged], [t(a) for a in nat], {"y": -2, "x": -1}[key]


ROWS = {"y": fused.fused_schur_y_pre, "x": fused.fused_schur_x_pre}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key,shape", [
    ("y", (1, 912, 912)), ("x", (1, 912, 912)),    # ZION 48x48: 912 lines of 912
    ("y", (1, 544, 544)), ("x", (1, 544, 544)),    # KOEBERG 32x32
    ("y", (3, 45, 37)), ("x", (3, 45, 37)),        # n no multiple of 32, lines of 8
    ("y", (2, 20, 13)), ("x", (2, 20, 13)),        # n < 32
    ("y", (4, 1, 7)), ("x", (2, 5, 1))])           # n = 1
def test_fused_rows_kernel_matches_plain(cuda, dtype, key, shape):
    """The tiled K2 / K3 kernel against the plain version, launched (and
    counted) under its own key, the thread-per-line kernel not at all."""
    v, acc, staged, nat, axis = _rows_operands(key, shape, dtype, cuda, 30)
    want = fused.fused_dir_plain(acc, v, *nat, axis, 0.5, -0.5, 0.25)
    before = dict(fused.LAUNCHES)
    got = ROWS[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert fused.LAUNCHES[f"{key}_rows"] == before[f"{key}_rows"] + 1
    assert fused.LAUNCHES[key] == before[key]


@pytest.mark.parametrize("key", ["y", "x"])
def test_fused_rows_kernel_is_deterministic(cuda, key):
    """No atomics: two launches on the same operands agree bit for bit."""
    v, acc, staged, _, _ = _rows_operands(key, (1, 912, 912), torch.float32, cuda, 31)
    first = ROWS[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    second = ROWS[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_rows_kernel_refuses_a_line_too_long(cuda):
    """A line no tile of shared memory holds is refused by the card, and the
    wrapper raises (no fallback to the thread-per-line kernel); the error
    does not leak into the next launch."""
    v, acc, staged, nat, axis = _rows_operands("x", (1, 1, 25000), torch.float64, cuda, 32)
    before = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="tiled kernel"):
        fused.fused_schur_x_pre(acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    assert fused.LAUNCHES == before
    v, acc, staged, nat, axis = _rows_operands("x", (2, 5, 9), torch.float64, cuda, 33)
    got = fused.fused_schur_x_pre(acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    want = fused.fused_dir_plain(acc, v, *nat, axis, 0.5, -0.5, 0.25)
    assert _rel(got, want, acc) <= TOL[torch.float64]


def _batched_operands(key, ng, shape, dtype, device, seed, pinned=False):
    """Per-group staged operands of the batched wrapper for ``key`` and their
    natural layouts (ng, 1, face grid) for the plain version; ``pinned``: two
    pinned face planes in every group (l = dm = 0: the first and one inside)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    ax = {"z": 0, "y": 1, "x": 2}[key]
    fsh = [nz, ny, nx]
    fsh[ax] += 1
    dm = rng.uniform(0.2, 0.6, (ng, *fsh))
    l = rng.uniform(-0.3, 0.3, (ng, nz, ny, nx))
    if pinned:
        for f in {0, shape[ax] // 2}:
            np.moveaxis(dm, ax + 1, 0)[f] = 0.0
            np.moveaxis(l, ax + 1, 0)[f] = 0.0
    if key == "z":
        staged = (dm, l)
    elif key == "y":
        staged = (np.moveaxis(dm, 2, 1), np.moveaxis(l, 2, 1))
    else:
        staged = (np.swapaxes(dm.reshape(ng, -1, nx + 1), 1, 2),
                  np.swapaxes(l.reshape(ng, -1, nx), 1, 2))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    v, acc = (t(rng.standard_normal((ng, 1, nz, ny, nx))) for _ in range(2))
    return v, acc, [t(a) for a in staged], [t(a[:, None]) for a in (dm, l)], ax - 3


BATCHED = {"z": fused.fused_schur_z_batched, "y": fused.fused_schur_y_batched,
           "x": fused.fused_schur_x_batched}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", ["z", "y", "x"])
@pytest.mark.parametrize("ng,shape", [(2, (9, 10, 11)), (3, (5, 33, 70)), (4, (1, 40, 37)),
                                      (2, (76, 114, 114))])
def test_fused_batched_kernel_matches_plain(cuda, dtype, key, ng, shape):
    """K5 (y, x) and K1's group batch (z), the batched tiled kernels, on
    group-batched fluxes: the Jacobi sweep's (2, 1, 76, 114, 114), line counts
    that are no multiple of a tile's lines or of the 128 threads of a block,
    and a 2D grid; each counted under its own key, every other kernel not at
    all."""
    v, acc, staged, nat, axis = _batched_operands(key, ng, shape, dtype, cuda, 20 + ng)
    want = fused.fused_dir_plain(acc, v, *nat, axis, 0.5, -0.5, 0.25)
    before = dict(fused.LAUNCHES)
    got = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    counted = f"{key}_batched_rows"
    assert {k: fused.LAUNCHES[k] - before[k] for k in fused.LAUNCHES} == {
        k: int(k == counted) for k in fused.LAUNCHES}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", ["z", "y", "x"])
@pytest.mark.parametrize("ng,shape", [(1, (6, 9, 11)), (2, (3, 45, 37)), (3, (2, 20, 13)),
                                      (4, (4, 1, 7)), (2, (1, 300, 280))])
def test_fused_batched_rows_kernel_matches_plain(cuda, dtype, key, ng, shape):
    """The batched tiled kernels (K5, K1's batch) at ragged shapes: one
    group, n no multiple of the chunks, lines no multiple of a tile, n = 1, a
    2D grid; two pinned face planes per group."""
    v, acc, staged, nat, axis = _batched_operands(key, ng, shape, dtype, cuda, 40 + ng,
                                                  pinned=True)
    want = fused.fused_dir_plain(acc, v, *nat, axis, 0.5, -0.5, 0.25)
    before = dict(fused.LAUNCHES)
    got = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert fused.LAUNCHES[f"{key}_batched_rows"] == before[f"{key}_batched_rows"] + 1
    assert fused.LAUNCHES[f"{key}_batched"] == before[f"{key}_batched"]


@pytest.mark.parametrize("key", ["z", "y", "x"])
def test_fused_batched_rows_kernel_is_deterministic(cuda, key):
    """No atomics: two launches of the batched tiled kernel agree bit for bit."""
    v, acc, staged, _, _ = _batched_operands(key, 2, (76, 114, 114), torch.float32, cuda, 50)
    first = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    second = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_batched_rejects_what_it_does_not_take(cuda):
    v, acc, (dm, l), _, _ = _batched_operands("y", 2, (4, 5, 6), torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="groups"):  # group counts that disagree
        fused.fused_schur_y_batched(acc, v, dm[:1].contiguous(), l[:1].contiguous(),
                                    0.5, -0.5, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_schur_y_batched(acc, v, dm, l.transpose(-1, -2).contiguous()
                                    .transpose(-1, -2), 0.5, -0.5, 0.25)
    with pytest.raises(TypeError):  # an operand of another dtype
        fused.fused_schur_y_batched(acc, v, dm.double(), l, 0.5, -0.5, 0.25)
    with pytest.raises(TypeError):  # an unsupported dtype
        h = [x.half() for x in (acc, v, dm, l)]
        fused.fused_schur_y_batched(*h, 0.5, -0.5, 0.25)


def test_kernels_reject_what_they_do_not_take(cuda):
    v = torch.zeros((1, 4, 5, 6), device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        fused.fused_schur_z(v, v, torch.zeros((5, 5, 6), device=cuda),
                            torch.zeros((4, 5, 6), device=cuda, dtype=torch.float64),
                            0.5, -0.5, 0.25)
    with pytest.raises(ValueError):
        thomas.thomas_solve(v, v, torch.zeros((1, 3, 5, 6), device=cuda).transpose(-1, -2),
                            -3)


def _ho_operands(k, axis, dtype, device, seed, shape=(5, 6, 7)):
    """RT_k-P_k tables of a small mesh's direction on ``axis`` and random staged
    operands (two pinned faces, the first and one inside: l = dm = 0 there)
    plus their natural layouts."""
    nz, ny, nx = shape
    fes = fespace.make_fespace(mesh.CartesianMesh.from_breaks(
        np.linspace(0, 7, nx + 1), np.linspace(0, 6, ny + 1), np.linspace(0, 5, nz + 1)), k, k)
    di = [d for d in fes.dirs if d.axis == axis][0]
    tabs = fused_ho.ho_tables(fes, di)
    rng = np.random.default_rng(seed)
    n = (nz, ny, nx)[axis]
    rest = [s for a, s in enumerate((nz, ny, nx)) if a != axis]

    def t(*s, lo=None, hi=None):
        a = rng.uniform(lo, hi, s) if lo is not None else rng.standard_normal(s)
        return torch.as_tensor(a, dtype=dtype, device=device)

    dm, l, a = t(n + 1, *rest, lo=0.2, hi=0.6), t(n, *rest, lo=-0.3, hi=0.3), t(n, *rest, lo=0.5, hi=2.0)
    for f in {0, n // 2}:  # pinned faces: the first and one inside
        dm[f] = 0.0
        l[f] = 0.0
    # natural layouts (solve axis back in place) and the wrappers' staged ones
    nat = [x.movedim(0, axis) for x in (dm, l, a)]
    if axis == 0:
        staged = (dm, l, a)
    elif axis == 1:
        staged = tuple(x.contiguous() for x in (dm, l, a))  # (n, nz, nx)
    else:
        staged = tuple(x.reshape(x.shape[0], -1).contiguous() for x in (dm, l, a))
    v, acc = t(1, fes.P, nz, ny, nx), t(1, fes.P, nz, ny, nx)
    return tabs, v, acc, staged, nat


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_ho_kernel_matches_plain(cuda, dtype, k, axis):
    """The tiled K6 kernel, counted under its own key; the thread-per-(mode,
    line) kernel not at all."""
    tabs, v, acc, staged, nat = _ho_operands(k, axis, dtype, cuda, 10 * k + axis)
    want = fused_ho.fused_ho_plain(acc, v, *nat, axis - 3, tabs)
    before = dict(fused_ho.LAUNCHES)
    got = HO[axis](acc.clone(), v, *staged, tabs)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    key = ("ho_z", "ho_y", "ho_x")[axis]
    assert {k_: fused_ho.LAUNCHES[k_] - before[k_] for k_ in fused_ho.LAUNCHES} == {
        k_: int(k_ == f"{key}_rows") for k_ in fused_ho.LAUNCHES}


HO = (fused_ho.fused_ho_z, fused_ho.fused_ho_y, fused_ho.fused_ho_x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape", [(9, 13, 11), (38, 19, 21), (1, 3, 2), (6, 76, 5)])
@pytest.mark.parametrize("modes", [1, "K1"])
def test_fused_ho_rows_kernel_matches_plain(cuda, dtype, k, axis, shape, modes, monkeypatch):
    """The tiled K6 kernel at ragged shapes: n no multiple of the chunks,
    line counts no multiple of a tile, n = 1 (z of the third shape), the
    paths' n = 38 and 76; two pinned face planes (the first and one inside);
    one transverse mode per block, and K1 of them."""
    monkeypatch.setattr(fused_ho, "HO_MODES", {k + 1: k + 1 if modes == "K1" else 1})
    tabs, v, acc, staged, nat = _ho_operands(k, axis, dtype, cuda, 60 + 10 * k + axis, shape)
    want = fused_ho.fused_ho_plain(acc, v, *nat, axis - 3, tabs)
    got = HO[axis](acc.clone(), v, *staged, tabs)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_ho_rows_kernel_is_deterministic(cuda, axis):
    """No atomics: two launches on RT2-P2 operands agree bit for bit."""
    tabs, v, acc, staged, _ = _ho_operands(2, axis, torch.float32, cuda, 70, (38, 76, 76))
    first = HO[axis](acc.clone(), v, *staged, tabs)
    second = HO[axis](acc.clone(), v, *staged, tabs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_ho_rows_kernel_refuses_a_tile_too_large(cuda):
    """A line no tile of shared memory holds (RT2-P2 float64, 8000 cells) is
    refused by the card and the wrapper raises, counting nothing (no fallback
    to the thread-per-(mode, line) kernel); the next launch succeeds."""
    tabs, v, acc, staged, _ = _ho_operands(2, 2, torch.float64, cuda, 71, (1, 1, 8000))
    assert fused_ho.ho_smem(8000, *fused_ho.ho_tile(1, 8000, 3, torch.float64), 3, 8) > \
        fused_ho.SMEM_PER_BLOCK
    before = dict(fused_ho.LAUNCHES)
    with pytest.raises(RuntimeError, match="tiled kernel"):
        fused_ho.fused_ho_x(acc.clone(), v, *staged, tabs)
    assert fused_ho.LAUNCHES == before
    tabs, v, acc, staged, nat = _ho_operands(2, 2, torch.float64, cuda, 72)
    got = fused_ho.fused_ho_x(acc.clone(), v, *staged, tabs)
    torch.cuda.synchronize()
    assert _rel(got, fused_ho.fused_ho_plain(acc, v, *nat, -1, tabs), acc) <= TOL[torch.float64]


def test_fused_ho_rejects_what_it_does_not_take(cuda):
    tabs, v, acc, staged, _ = _ho_operands(1, 0, torch.float32, cuda, 0)
    with pytest.raises(TypeError):  # operand of another dtype
        fused_ho.fused_ho_z(acc, v, staged[0].double(), *staged[1:], tabs)
    with pytest.raises(ValueError):  # non-contiguous operand
        fused_ho.fused_ho_z(acc, v, staged[0], staged[1].transpose(-1, -2).contiguous()
                            .transpose(-1, -2), staged[2], tabs)
    fes3 = fespace.make_fespace(mesh.CartesianMesh.from_breaks(*[np.linspace(0, 3, 4)] * 3), 3, 3)
    di = [d for d in fes3.dirs if d.axis == 0][0]
    v3 = torch.zeros((1, fes3.P, 3, 3, 3), device=cuda)
    z = torch.zeros((4, 3, 3), device=cuda)
    with pytest.raises(NotImplementedError):  # K1 = 4: no kernel instantiated
        fused_ho.fused_ho_z(v3.clone(), v3, z, z[:3].contiguous(), z[:3].contiguous(),
                            fused_ho.ho_tables(fes3, di))


EQ_WRAPPERS = {"x_eq": (fused_eq.fused_schur_x_eq, -1), "z_eq": (fused_eq.fused_schur_z_eq, -3),
               "x_eq2": (fused_eq.fused_schur_x_eq2, -1), "y_eq2": (fused_eq.fused_schur_y_eq2, -2),
               "z_eq2": (fused_eq.fused_schur_z_eq2, -3)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", sorted(EQ_WRAPPERS))
@pytest.mark.parametrize("shape", [(9, 10, 11), (5, 33, 70), (76, 114, 114)])
def test_fused_eq_kernel_matches_plain(cuda, dtype, key, shape):
    """The tiled K7 (one template, five flag sets) against its plain version
    on the CPU, on the same operands: IAEA-3D 6x6x4's grid, and line counts
    that are no multiple of a tile's lines (110, 99, 90; 2310, 350, 165)."""
    rng = np.random.default_rng(30)
    nz, ny, nx = shape
    wrapper, axis = EQ_WRAPPERS[key]
    fsh = {-3: (nz + 1, ny, nx), -2: (ny + 1, nz, nx), -1: (nx + 1, nz * ny)}[axis]
    lsh = {-3: (nz, ny, nx), -2: (ny, nz, nx), -1: (nx, nz * ny)}[axis]
    ops = [rng.uniform(0.2, 0.6, fsh), rng.uniform(-0.3, 0.3, lsh)]
    ops[0][0] = 0.0  # a pinned first face: l = dm = 0 there
    ops[1][0] = 0.0
    y, acc = rng.standard_normal((2, 1, *shape))
    sdi, ce = rng.uniform(0.5, 2.0, (2, 1, *shape))

    def run(device):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # a copy: acc is updated
        dm, l = t(ops[0]), t(ops[1])
        if key in ("x_eq", "x_eq2"):
            out = wrapper(t(y), t(sdi), t(ce), dm, l, 0.5, -0.5, 0.25)
            return out if key == "x_eq" else (out, None)
        a = t(acc)
        if key == "z_eq":
            got = wrapper(a, t(y), dm, l, t(sdi), 0.5, -0.5, 0.25)
        else:
            got = wrapper(a, t(y), t(sdi), dm, l, 0.5, -0.5, 0.25)
        assert got is a  # in place
        return got, None

    before = dict(fused_eq.LAUNCHES)
    got, got_u = run(cuda)
    torch.cuda.synchronize()
    assert {k: fused_eq.LAUNCHES[k] - before[k] for k in fused_eq.LAUNCHES} == {
        k: int(k == f"{key}_rows") for k in fused_eq.LAUNCHES}
    want, want_u = run("cpu")
    base = torch.as_tensor(acc if key.startswith(("y", "z")) else np.zeros_like(acc),
                           dtype=dtype)
    assert _rel(got.cpu(), want, base) <= TOL[dtype]
    if key == "x_eq":
        assert float(torch.max(torch.abs(got_u.cpu() - want_u))) == 0.0  # u = sdi*y exactly


@pytest.mark.parametrize("key", sorted(EQ_WRAPPERS))
def test_fused_eq_kernel_is_deterministic(cuda, key):
    """No atomics: two launches of the tiled K7 agree bit for bit."""
    rng = np.random.default_rng(31)
    wrapper, axis = EQ_WRAPPERS[key]
    nz, ny, nx = shape = (76, 114, 114)
    fsh = {-3: (nz + 1, ny, nx), -2: (ny + 1, nz, nx), -1: (nx + 1, nz * ny)}[axis]
    lsh = {-3: shape, -2: (ny, nz, nx), -1: (nx, nz * ny)}[axis]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    dm, l = t(rng.uniform(0.2, 0.6, fsh)), t(rng.uniform(-0.3, 0.3, lsh))
    y, acc = (t(rng.standard_normal((1, *shape))) for _ in range(2))
    sdi, ce = (t(rng.uniform(0.5, 2.0, (1, *shape))) for _ in range(2))

    def run():
        if key.startswith("x"):
            out = wrapper(y, sdi, ce, dm, l, 0.5, -0.5, 0.25)
            return out[0] if key == "x_eq" else out
        if key == "z_eq":
            return wrapper(acc.clone(), y, dm, l, sdi, 0.5, -0.5, 0.25)
        return wrapper(acc.clone(), y, sdi, dm, l, 0.5, -0.5, 0.25)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_eq_ce_times_y_is_rounded_on_its_own(cuda):
    """ce*y + contribution with ce at IAEA-3D's absorber scale (1e9-3e9) and
    |y| >= 0.5: ce*y is >= 5e8, whose half ulp (>= 16) dwarfs the O(1)
    contribution, so the plain version's round(round(ce*y) + contribution)
    is round(ce*y) in every cell.  The tiled kernel rounds ce*y before the
    add and must give those bits; an FMA, round(ce*y + contribution), would
    land a whole ulp off in about half the cells."""
    rng = np.random.default_rng(32)
    nz, ny, nx = shape = (4, 8, 64)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    dm, l = t(rng.uniform(0.2, 0.6, (nx + 1, nz * ny))), t(rng.uniform(-0.3, 0.3, (nx, nz * ny)))
    y = t(rng.choice([-1.0, 1.0], (1, *shape)) * rng.uniform(0.5, 2.0, (1, *shape)))
    sdi, ce = t(rng.uniform(0.5, 2.0, (1, *shape))), t(rng.uniform(1e9, 3e9, (1, *shape)))
    want = fused_eq.fused_schur_x_eq2(y, sdi, ce, dm, l, 0.5, -0.5, 0.25)
    assert torch.equal(want, ce * y)  # the premise: the contribution rounds away
    got = fused_eq.fused_schur_x_eq2(*(a.to(cuda) for a in (y, sdi, ce, dm, l)),
                                     0.5, -0.5, 0.25).cpu()
    assert torch.equal(got, want)


def test_fused_eq_rejects_what_it_does_not_take(cuda):
    y = torch.zeros((1, 4, 5, 6), device=cuda)
    dm, l = torch.zeros((5, 5, 6), device=cuda), torch.zeros((4, 5, 6), device=cuda)
    with pytest.raises(TypeError):  # an operand of another dtype
        fused_eq.fused_schur_z_eq2(y.clone(), y, y.double(), dm, l, 0.5, -0.5, 0.25)
    with pytest.raises(ValueError):  # the z operands for the y direction
        fused_eq.fused_schur_y_eq2(y.clone(), y, y, dm, l, 0.5, -0.5, 0.25)
    with pytest.raises(TypeError):  # float16
        h = y.half()
        fused_eq.fused_schur_z_eq2(h.clone(), h, h, dm.half(), l.half(), 0.5, -0.5, 0.25)


def _blockjac_operands(P, shape, bdtype, device, seed):
    rng = np.random.default_rng(seed)
    bi = torch.as_tensor(rng.standard_normal((P, P, *shape)), dtype=torch.float32)
    bi = (bi + 4.0 * torch.eye(P).reshape(P, P, 1, 1, 1)).to(bdtype).to(device)
    r = torch.as_tensor(rng.standard_normal((P, *shape)), dtype=torch.float32, device=device)
    return bi, r


@pytest.mark.parametrize("bdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P", [8, 27, 5])
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 16, 64)])
def test_blockjac_kernel_matches_plain(cuda, P, bdtype, shape):
    """K8 (the tiled kernel, inverse forms) against its plain version on the
    same blocks: z to rel 1e-5 (the same products in another order; bf16
    entries widen exactly), the dots to rel 1e-5 (the kernel's float64 sums
    rounded once against the plain version's float32 sum).  1,173 cells is no multiple of 16 (one value
    per access) and of the tile; 2,048 takes the 16-byte path; P = 5 the
    generic kernel."""
    bi, r = _blockjac_operands(P, shape, bdtype, cuda, P)
    before = dict(blockjac.LAUNCHES)
    z, rz, rr = blockjac.blockjac_dots(bi, r)
    torch.cuda.synchronize()
    assert {k: blockjac.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "blockjac_tiled") for k in before}
    zp, rzp, rrp = blockjac.blockjac_dots_plain(bi, r)
    assert _rel(z, zp, torch.zeros_like(zp)) <= 1e-5
    assert abs(float(rz) - float(rzp)) <= 1e-5 * abs(float(rzp))
    assert abs(float(rr) - float(rrp)) <= 1e-5 * abs(float(rrp))


@pytest.mark.parametrize("P", [8, 27])
def test_blockjac_dots_against_float64_sum(cuda, P):
    """The kernel's dots against the same sums taken in float64 from its z:
    within one float32 rounding, rel 1e-7 (the kernel sums the exact float64
    products in float64 and rounds once)."""
    bi, r = _blockjac_operands(P, (5, 41, 67), torch.bfloat16, cuda, 40 + P)
    z, rz, rr = blockjac.blockjac_dots(bi, r)
    r64, z64 = r.double(), z.double()
    want_rz, want_rr = float(torch.sum(r64 * z64)), float(torch.sum(r64 * r64))
    assert abs(float(rz) - want_rz) <= 1e-7 * abs(want_rz)
    assert abs(float(rr) - want_rr) <= 1e-7 * abs(want_rr)


def test_blockjac_is_deterministic(cuda):
    """Two launches on the same operands give the same bits: no atomics, the
    per-block partials are summed in a fixed order."""
    bi, r = _blockjac_operands(27, (4, 76, 76), torch.bfloat16, cuda, 50)
    a = blockjac.blockjac_dots(bi, r)
    b = blockjac.blockjac_dots(bi, r)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_blockjac_rejects_what_it_does_not_take(cuda):
    bi, r = _blockjac_operands(8, (2, 3, 4), torch.bfloat16, cuda, 0)
    with pytest.raises(TypeError):  # a float64 residual
        blockjac.blockjac_dots(bi, r.double())
    with pytest.raises(TypeError):  # float16 blocks
        blockjac.blockjac_dots(bi.half(), r)
    with pytest.raises(ValueError):  # non-contiguous blocks
        blockjac.blockjac_dots(bi.transpose(-1, -2).contiguous().transpose(-1, -2), r)


def _eform_operands(P, shape, device, seed):
    """An E-form (P, P, *shape) float8_e4m3fn from scaled normals, and r."""
    rng = np.random.default_rng(seed)
    dev = torch.as_tensor(0.3 * rng.standard_normal((P, P, *shape)), dtype=torch.float32)
    r = torch.as_tensor(rng.standard_normal((P, *shape)), dtype=torch.float32, device=device)
    return dev.to(torch.float8_e4m3fn).to(device), r


def _dots_agree(got, want, tol=1e-5):
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= tol * abs(float(w))


@pytest.mark.parametrize("P", [8, 27, 5])
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 16, 64), (38, 76, 76)])
def test_blockjac_dev_kernel_matches_plain(cuda, P, shape):
    """K8 on the fp8 E-form against its plain version: z to rel 1e-5 of the
    deviation part E r (the identity is added exactly, the e4m3 entries widen
    exactly), the dots to rel 1e-5; the launch counted under blockjac_dev.
    (38, 76, 76): the RT_k-P_k 4x4x2 cell count."""
    dev, r = _eform_operands(P, shape, cuda, 70 + P)
    before = dict(blockjac.LAUNCHES)
    got = blockjac.blockjac_dev_dots(dev, r)
    torch.cuda.synchronize()
    assert {k: blockjac.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "blockjac_dev") for k in before}
    want = blockjac.blockjac_dots_plain(dev, r, deviation=True)
    assert _rel(got[0], want[0], r) <= 1e-5
    _dots_agree(got, want)


@pytest.mark.parametrize("form", ["E-form", "bf16", "f32"])
@pytest.mark.parametrize("P", [8, 27])
def test_blockjac_tiled_kernel_at_every_tile(cuda, form, P):
    """Every (wide, warps) tile the launcher takes (8- and 16-byte plane
    loads, 1..9 warps up to P) gives the plain version's z (rel 1e-5) and
    dots (rel 1e-5), and the same bits for z and the dots at every tile (z
    per cell in one order; the dots summed in float64 and rounded once);
    more warps than rows, or than 9, is refused and raises."""
    shape = (5, 40, 48)  # 9,600 cells: 16-byte path, a ragged last tile
    if form == "E-form":
        blk, r = _eform_operands(P, shape, cuda, 80 + P)
        fn, deviation = blockjac.blockjac_dev_dots, True
    else:
        blk, r = _blockjac_operands(P, shape, torch.bfloat16 if form == "bf16" else torch.float32,
                                    cuda, 80 + P)
        fn, deviation = blockjac.blockjac_dots, False
    want = blockjac.blockjac_dots_plain(blk, r, deviation)
    base = r if deviation else torch.zeros_like(r)
    first = fn(blk, r, (1, 1))
    for wide in (1, 0):
        for warps in range(1, min(P, 9) + 1):
            got = fn(blk, r, (wide, warps))
            torch.cuda.synchronize()
            assert _rel(got[0], want[0], base) <= 1e-5, (wide, warps)
            _dots_agree(got, want)
            assert all(torch.equal(a, b) for a, b in zip(got, first)), (wide, warps)
    for warps in (10, P + 1):
        with pytest.raises(RuntimeError, match="tiled kernel"):
            fn(blk, r, (1, warps))


@pytest.mark.parametrize("P", [8, 27])
def test_blockjac_tiled_kernel_matches_thread_per_cell(cuda, P):
    """The tiled kernel against the thread-per-cell kernel it replaced
    (csrc/blockjac.cu, called through the library) on the same bf16 blocks:
    z to rel 1e-5, the dots to rel 1e-5."""
    from neutfem_tpu_torch.ops import cuda_lib

    bi, r = _blockjac_operands(P, (4, 76, 76), torch.bfloat16, cuda, 90 + P)
    cells = r.numel() // P
    lib = cuda_lib.library()
    z = torch.empty_like(r)
    part = torch.empty((lib.neutfem_blockjac_blocks(cells), 2), device=cuda)
    cuda_lib.check(lib.neutfem_blockjac_bf16(bi.data_ptr(), r.data_ptr(), z.data_ptr(),
                                             part.data_ptr(), P, cells,
                                             torch.cuda.current_stream().cuda_stream), "old")
    rz, rr = torch.sum(part, dim=0)
    got = blockjac.blockjac_dots(bi, r)
    assert _rel(got[0], z, torch.zeros_like(z)) <= 1e-5
    _dots_agree(got, (z, rz, rr))


def test_blockjac_tiled_kernel_with_unaligned_operands(cuda):
    """Operands one value past a 16-byte boundary take the one-value path,
    with the same result as the aligned ones (rel 1e-5)."""
    dev, r = _eform_operands(27, (2, 16, 64), cuda, 95)

    def shifted(a):
        buf = torch.empty(a.numel() * a.element_size() + 4, dtype=torch.uint8, device=cuda)
        out = buf[4:].view(a.dtype).view(a.shape)
        out.copy_(a)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    want = blockjac.blockjac_dots_plain(dev, r, deviation=True)
    got = blockjac.blockjac_dev_dots(shifted(dev), shifted(r))
    assert _rel(got[0], want[0], r) <= 1e-5
    _dots_agree(got, want)


def test_e4m3_widening_is_exact(cuda):
    """K8's e4m3 widening (cvt e4m3x2 -> f16x2 -> f32) of all 254 finite e4m3
    bytes equals torch's float8_e4m3fn -> float32: at P = 1 on r = 1 the
    E-form gives z = 1 + E, exact in float32 for every e4m3 value, so z - 1
    is the widened entry, equal in value (the same bits but for the sign of
    zero, which z = 1 + E cannot show; 256 cells: the 16-byte path)."""
    finite = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F] + [0, 0],
                          dtype=torch.uint8, device=cuda).view(torch.float8_e4m3fn)
    z = blockjac.blockjac_dev_dots(finite.reshape(1, 1, -1), torch.ones((1, 256), device=cuda))[0]
    assert torch.equal((z - 1.0).reshape(-1), finite.float())


def test_blockjac_dev_is_deterministic(cuda):
    dev, r = _eform_operands(27, (4, 76, 76), cuda, 96)
    a = blockjac.blockjac_dev_dots(dev, r)
    b = blockjac.blockjac_dev_dots(dev, r)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_blockjac_dev_rejects_what_it_does_not_take(cuda):
    dev, r = _eform_operands(8, (2, 3, 4), cuda, 0)
    with pytest.raises(TypeError):  # bf16 blocks through the E-form entry
        blockjac.blockjac_dev_dots(dev.float().bfloat16(), r)
    with pytest.raises(TypeError):  # the E-form through the inverse entry
        blockjac.blockjac_dots(dev, r)
    with pytest.raises(TypeError):  # a float64 residual
        blockjac.blockjac_dev_dots(dev, r.double())


def _thomas_operands(shape, axis, dtype, device, seed):
    rng = np.random.default_rng(seed)
    lshape = list(shape)
    lshape[axis] -= 1
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    dinv = torch.as_tensor(rng.uniform(0.3, 0.6, shape), dtype=dtype, device=device)
    l = torch.as_tensor(rng.uniform(-0.4, 0.4, lshape), dtype=dtype, device=device)
    return rhs, dinv, l


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,axis", [
    ((1, 152, 152, 152), -3),      # the 8x8x8 line preconditioner
    ((2, 1, 77, 114, 114), -3),    # compute_current at 6x6x4: z, y, x
    ((2, 1, 76, 115, 114), -2),
    ((2, 1, 76, 114, 115), -1),
    ((3, 1, 5, 33, 70), -3),       # ragged: lines no multiple of the tile
    ((3, 1, 5, 33, 70), -2),
    ((3, 1, 5, 33, 70), -1),
    ((2, 1, 1, 9, 70), -3),        # n = 1
    ((1, 300, 3, 5), -3),          # fewer lines than one tile, inner 15
    ((2, 1, 20, 19, 19), -2)])     # IAEA-3D 1x1's y faces
def test_thomas_rows_kernel_matches_plain(cuda, dtype, shape, axis):
    """The tiled K4 against the plain recurrence: rel 1e-12 (float64) / 1e-5
    (float32), the chunk carries composing the same sums in another
    association; counted under thomas_rows, never thomas."""
    rhs, dinv, l = _thomas_operands(shape, axis, dtype, cuda, 20)
    before = dict(thomas.LAUNCHES)
    got = thomas.thomas_solve(rhs, dinv, l, axis)
    torch.cuda.synchronize()
    assert {k: thomas.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "thomas_rows") for k in before}
    want = thomas.thomas_solve_plain(rhs, dinv, l, axis)
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("axis", [-3, -2, -1])
def test_thomas_rows_kernel_matches_thread_per_line(cuda, dtype, axis):
    """The tiled K4 against the thread-per-line kernel it replaced
    (thomas_kernel, called through the library): rel 1e-12 / 1e-5."""
    from neutfem_tpu_torch.ops import cuda_lib

    shape = (2, 1, 20, 33, 70)
    rhs, dinv, l = _thomas_operands(shape, axis, dtype, cuda, 21)
    n = shape[axis]
    inner = math.prod(shape[axis % len(shape) + 1:])
    old = torch.empty_like(rhs)
    fn = cuda_lib.library().neutfem_thomas_f64 if dtype == torch.float64 else \
        cuda_lib.library().neutfem_thomas_f32
    cuda_lib.check(fn(rhs.data_ptr(), dinv.data_ptr(), l.data_ptr(), old.data_ptr(), n,
                      rhs.numel() // n, inner, torch.cuda.current_stream().cuda_stream), "old")
    got = thomas.thomas_solve(rhs, dinv, l, axis)
    assert _rel(got, old, torch.zeros_like(old)) <= TOL[dtype]


@pytest.mark.parametrize("axis", [-3, -2, -1])
def test_thomas_rows_kernel_at_every_tile(cuda, axis):
    """Every tile (lines 1..64 x chunks 1..128, 32 to 1,024 threads) gives
    the plain version's x (float64, rel 1e-12); a block under one warp is
    refused and raises."""
    rhs, dinv, l = _thomas_operands((2, 1, 7, 45, 66), axis, torch.float64, cuda, 22)
    want = thomas.thomas_solve_plain(rhs, dinv, l, axis)
    for tl in (1, 2, 4, 8, 16, 32, 64):
        for ch in (1, 2, 4, 8, 16, 32, 64, 128):
            if not 32 <= tl * ch <= 1024:
                continue
            got = thomas.thomas_solve(rhs, dinv, l, axis, (tl, ch))
            torch.cuda.synchronize()
            assert _rel(got, want, torch.zeros_like(want)) <= 1e-12, (tl, ch)
    with pytest.raises(RuntimeError, match="tiled kernel"):
        thomas.thomas_solve(rhs, dinv, l, axis, (8, 2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_thomas_rows_kernel_with_unaligned_operands(cuda, dtype):
    """Operands one value past a 16-byte boundary: one value per copy, the
    same result."""
    rhs, dinv, l = _thomas_operands((2, 1, 30, 16, 64), -3, dtype, cuda, 23)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -3)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    got = thomas.thomas_solve(shifted(rhs), shifted(dinv), shifted(l), -3)
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]


def test_thomas_rows_kernel_is_deterministic(cuda):
    rhs, dinv, l = _thomas_operands((1, 152, 152, 152), -3, torch.float32, cuda, 24)
    assert torch.equal(thomas.thomas_solve(rhs, dinv, l, -3), thomas.thomas_solve(rhs, dinv, l, -3))


def test_thomas_rows_kernel_refuses_a_line_too_long(cuda):
    """Lines no one-line tile holds (25,000 float64 elements): the card
    refuses, the wrapper raises (no fallback), and nothing is counted."""
    rhs, dinv, l = _thomas_operands((25000, 2), -2, torch.float64, cuda, 25)
    before = dict(thomas.LAUNCHES)
    with pytest.raises(RuntimeError, match="tiled kernel"):
        thomas.thomas_solve(rhs, dinv, l, -2)
    assert thomas.LAUNCHES == before


def _wide_old(rhs, dinv, l):
    """The first K4′ kernel (thomas_wide_kernel), called through the library:
    no launch counted."""
    from neutfem_tpu_torch.ops import cuda_lib

    n = rhs.shape[-2]
    out = torch.empty_like(rhs)
    fn = cuda_lib.library().neutfem_thomas_wide_f64 if rhs.dtype == torch.float64 else \
        cuda_lib.library().neutfem_thomas_wide_f32
    cuda_lib.check(fn(rhs.data_ptr(), dinv.data_ptr(), l.data_ptr(), out.data_ptr(), n,
                      rhs.numel() // n, rhs.shape[-1], torch.cuda.current_stream().cuda_stream),
                   "thomas_wide_kernel")
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1, 1, 913, 912),   # ZION 48x48 compute_current y
                                   (4, 1, 1, 545, 544),   # KOEBERG 32x32
                                   (1, 1, 912, 912),      # the ZION line preconditioner
                                   (3, 1, 1, 1, 70000)])  # n = 1
def test_thomas_wide_rows_kernel_matches_plain_and_old(cuda, dtype, shape):
    """The tiled K4′ at the paths' shapes against the plain version and the
    kernel it replaced: rel 1e-12 (float64) / 1e-5 (float32)."""
    assert thomas.wide_rows(shape, -2)
    rhs, dinv, l = _thomas_operands(shape, -2, dtype, cuda, 30)
    got = thomas.thomas_solve(rhs, dinv, l, -2)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -2)
    zero = torch.zeros_like(want)
    assert _rel(got, want, zero) <= TOL[dtype]
    assert _rel(got, _wide_old(rhs, dinv, l), zero) <= TOL[dtype]


def test_thomas_wide_rows_kernel_at_every_tile(cuda):
    """Every tile (lines 1..16 x chunks 16..256, at most 256 threads) gives
    the plain version's x (float64, rel 1e-12), and the same bits at every
    line count for one chunk count; chunks of 8 are refused and raise."""
    shape = (2, 1, 1, 300, 230)
    assert thomas.wide_rows(shape, -2)
    rhs, dinv, l = _thomas_operands(shape, -2, torch.float64, cuda, 31)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -2)
    for ch in (16, 32, 64, 128, 256):
        first = None
        for tl in (1, 2, 4, 8, 16):
            if tl * ch > thomas.WIDE_THREADS:
                continue
            got = thomas.thomas_solve(rhs, dinv, l, -2, (tl, ch))
            torch.cuda.synchronize()
            assert _rel(got, want, torch.zeros_like(want)) <= 1e-12, (tl, ch)
            first = got if first is None else first
            assert torch.equal(got, first), (tl, ch)
    with pytest.raises(RuntimeError, match="K4′ tiled kernel"):
        thomas.thomas_solve(rhs, dinv, l, -2, (8, 8))


def test_thomas_wide_rows_kernel_is_deterministic(cuda):
    rhs, dinv, l = _thomas_operands((2, 1, 1, 913, 912), -2, torch.float32, cuda, 32)
    assert torch.equal(thomas.thomas_solve(rhs, dinv, l, -2), thomas.thomas_solve(rhs, dinv, l, -2))


def test_thomas_wide_rows_kernel_refuses_a_line_too_long(cuda):
    """A line whose three rows exceed the card's shared memory (19,100
    float32 elements): no tile, the wrapper raises (no fallback) and nothing
    is counted."""
    rhs, dinv, l = _thomas_operands((1, 1, 1, 19100, 40), -2, torch.float32, cuda, 33)
    before = dict(thomas.LAUNCHES)
    with pytest.raises(ValueError, match="K4′"):
        thomas.thomas_solve(rhs, dinv, l, -2)
    assert thomas.LAUNCHES == before


# --- the CG's captured blocks (krylov.CGGraph) --------------------------------

def _spd(n, device, seed=40):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    A = torch.as_tensor(a @ a.T / n + np.diag(rng.uniform(0.5, 2.0, n)), device=device)
    b = torch.as_tensor(rng.standard_normal(n), device=device)
    x0 = torch.as_tensor(rng.standard_normal(n), device=device)
    return A, b, x0, 1.0 / torch.diag(A)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tol,maxiter", [(1e-11, 1000), (1e-10, 13), (1e3, 1000)])
def test_cg_graph_matches_the_eager_blocks(cuda, fused, tol, maxiter):
    """pcg / pcg_fused on the card (the captured graph) against their eager
    block loop at BLOCK_ITERS on the card: the same bits and count; host
    reads ceil(n / BLOCK_ITERS), at least one."""
    from neutfem_tpu_torch import krylov

    A, b, x0, minv = _spd(48, cuda)
    kw = dict(precond=lambda r: minv * r, tol=tol, maxiter=maxiter)
    run, blocks = ((krylov.pcg_fused, krylov.pcg_fused_blocks) if fused
                   else (krylov.pcg, krylov.pcg_blocks))
    krylov.reset_stats()
    got = run(lambda x: A @ x, b, x0, **kw)
    reads = krylov.STATS["host_reads"]
    want = blocks(lambda x: A @ x, b, x0, block=krylov.BLOCK_ITERS, **kw)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x) and torch.equal(got.residual, want.residual)
    assert reads == max(1, -(-got.iterations // krylov.BLOCK_ITERS))
    assert krylov.STATS["captures"] == 1


def test_cg_graph_is_reused_and_counts_launches(cuda):
    """A CGGraph kept across solves is captured once; the kernel counters
    add the captured block's launches at every replay (the capture itself
    adds none): the operator is a K4 Thomas solve (T^-1, SPD)."""
    from neutfem_tpu_torch import krylov

    shape = (1, 20, 8, 8)
    rhs, dinv, l = _thomas_operands(shape, -3, torch.float64, cuda, 41)
    matvec = lambda x: thomas.thomas_solve(x, dinv, l, -3)
    graph = krylov.CGGraph()
    krylov.reset_stats()
    first = krylov.pcg(matvec, rhs, torch.zeros_like(rhs), tol=1e-10, graph=graph)
    for seed in (42, 43):
        b = _thomas_operands(shape, -3, torch.float64, cuda, seed)[0]
        before = thomas.LAUNCHES["thomas_rows"]
        replays = krylov.STATS["replays"]
        got = krylov.pcg(matvec, b, torch.zeros_like(b), tol=1e-10, graph=graph)
        replays = krylov.STATS["replays"] - replays
        assert replays == -(-got.iterations // krylov.BLOCK_ITERS)
        # the prologue's matvec, then BLOCK_ITERS matvecs a replay
        assert thomas.LAUNCHES["thomas_rows"] - before == 1 + replays * krylov.BLOCK_ITERS
        want = krylov.pcg_blocks(matvec, b, torch.zeros_like(b), tol=1e-10)
        assert got.iterations == want.iterations > 3 and torch.equal(got.x, want.x)
    assert krylov.STATS["captures"] == 1 and first.iterations > 3


@pytest.fixture(scope="module")
def iaea_1x1_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neutfem_tpu_torch import bench

    spec = bench.load_benchmark_data().BENCHMARKS["iaea3d"]
    return bench, spec


def _graph_vs_eager(fes, ctx, opts, g=0):
    """One group solve (the whole context for g None) through group_solve
    (the plan's graph, kept in the context) and through the plan's eager
    block loop: (graph result, eager result)."""
    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.power import ctx_group, group_plan, group_solve

    ctx.setdefault(krylov.CG_PLANS, krylov.CGPlans())
    ctxg = ctx if g is None else ctx_group(ctx, g)
    shape = ctx["C"].shape if g is None else ctx["C"].shape[1:]
    rng = np.random.default_rng(44)
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=ctx["C"].dtype, device="cuda")
    x0 = torch.zeros_like(rhs)
    got = group_solve(fes, ctxg, opts, rhs, x0)
    again = group_solve(fes, ctxg, opts, rhs, x0)  # the plan's graph, replayed again
    plan = group_plan(fes, ctxg, opts, rhs)
    assert plan.graph.graph is not None
    if plan.refill is not None:
        plan.refill()
    want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                       tol=opts.inner_tol, maxiter=opts.max_inner,
                       block=krylov.BLOCK_ITERS, **plan.kwargs())
    assert torch.equal(got.x, again.x) and got.iterations == again.iterations
    return got, want._replace(x=want.x * plan.sdi)


@pytest.mark.parametrize("case", ["rt0", "rt1", "jacobi", "cgcg", "eqfold2"])
def test_group_solve_graph_matches_eager_blocks(iaea_1x1_f32, case, monkeypatch):
    """group_solve on the card (its plan's captured graph) against the plan's
    eager block loop, IAEA-3D 1x1 float32: the same bits and count on the
    default RT0 path, RT1-P1 (K8 on the E-form), the Jacobi sweep's batched
    solve, NEUTFEM_CGCG=1 and NEUTFEM_EQFOLD=2."""
    from neutfem_tpu_torch.power import SolveOptions

    bench, spec = iaea_1x1_f32
    if case == "cgcg":
        monkeypatch.setenv("NEUTFEM_CGCG", "1")
    if case == "eqfold2":
        monkeypatch.setenv("NEUTFEM_EQFOLD", "2")
    run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32,
                             rt_order=1 if case == "rt1" else 0)
    s = run.solver
    got, want = _graph_vs_eager(s._fes, s._ctx, SolveOptions(inner_tol=1e-5),
                                None if case == "jacobi" else 0)
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x)


def test_group_solve_graphs_share_one_block_copy(iaea_1x1_f32, monkeypatch):
    """RT1-P1 under NEUTFEM_CGCG=1 takes the bmm block apply on a float32
    copy of the blocks: the context keeps one copy, which both groups' plans
    share and refill before each solve.  Group 0, group 1 and group 0 again
    through their graphs each give the bits and count of the eager block
    loop on a copy made for that group."""
    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.power import (SolveOptions, _block_precond, ctx_group, group_plan,
                                         group_solve)

    bench, spec = iaea_1x1_f32
    monkeypatch.setenv("NEUTFEM_CGCG", "1")
    run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32, rt_order=1)
    fes, ctx = run.solver._fes, run.solver._ctx
    ctx[krylov.CG_PLANS] = krylov.CGPlans()
    opts = SolveOptions(inner_tol=1e-5)
    rng = np.random.default_rng(45)
    for g in (0, 1, 0):
        ctxg = ctx_group(ctx, g)
        rhs = torch.as_tensor(rng.standard_normal(ctx["C"].shape[1:]), dtype=torch.float32,
                              device="cuda")
        x0 = torch.zeros_like(rhs)
        got = group_solve(fes, ctxg, opts, rhs, x0)
        plan = group_plan(fes, ctxg, opts, rhs)
        want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi,
                           precond=_block_precond(ctxg, torch.float32), tol=opts.inner_tol,
                           maxiter=opts.max_inner, block=krylov.BLOCK_ITERS)
        assert got.iterations == want.iterations > 2
        assert torch.equal(got.x, want.x * plan.sdi)
    assert len(ctx[krylov.CG_PLANS].buffers) == 1


def test_cg_plans_are_freed_with_their_context(iaea_1x1_f32, monkeypatch):
    """A context's plans, graphs and static buffers go with it.  Two rounds of
    build, one graph solve a group and release, at RT1-P1 under
    NEUTFEM_CGCG=1 (``pcg_fused`` and the ``torch.bmm`` block apply, cuBLAS
    in every capture): each round's ``CGPlans`` is unreachable once its
    solver is dropped, and the second round leaves as much device memory
    allocated as the first."""
    import gc
    import weakref

    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_solve

    bench, spec = iaea_1x1_f32
    monkeypatch.setenv("NEUTFEM_CGCG", "1")
    opts = SolveOptions(inner_tol=1e-5)
    after = []
    for _ in range(2):
        run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32, rt_order=1)
        fes, ctx = run.solver._fes, run.solver._ctx
        ctx[krylov.CG_PLANS] = krylov.CGPlans()
        plans = weakref.ref(ctx[krylov.CG_PLANS])
        rhs = torch.ones(ctx["C"].shape[1:], dtype=torch.float32, device="cuda")
        for g in range(ctx["C"].shape[0]):
            group_solve(fes, ctx_group(ctx, g), opts, rhs, torch.zeros_like(rhs))
        assert len(plans().plans) == ctx["C"].shape[0]
        del run, fes, ctx, rhs
        gc.collect()
        torch.cuda.synchronize()
        assert plans() is None
        after.append(torch.cuda.memory_allocated())
    assert after[1] == after[0]


def test_group_solve_graph_matches_eager_blocks_twogrid(cuda):
    """The same on KOEBERG 4x4 float32 with the two-grid level attached."""
    from neutfem_tpu_torch import bench
    from neutfem_tpu_torch.power import SolveOptions

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUTFEM_PRECOND", "twogrid")
        run = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["koeberg2d"], 4,
                                 device="cuda", dtype=torch.float32)
    s = run.solver
    assert "tg" in s._ctx
    got, want = _graph_vs_eager(s._fes, s._ctx, SolveOptions(inner_tol=1e-5,
                                                             inner_precond="twogrid"))
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x)


def test_anderson_solve_matches_the_cpu(iaea_1x1_f32):
    """IAEA-3D 1x1 float64 under ``set_acceleration("anderson")``: the card
    (kernels, CG graphs) against the CPU (plain versions), |dk| <= 1e-9 and
    the same outer count."""
    bench, spec = iaea_1x1_f32
    out = {}
    for device in ("cpu", "cuda"):
        run = bench.BenchmarkRun(spec, 1, 1, device=device, dtype=torch.float64)
        run.solver.set_acceleration("anderson")
        out[device] = (run.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000)), run.solver._last_outers,
                       run.solver._last_inners)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-9
    assert out["cuda"][1] == out["cpu"][1] > 2
    assert abs(out["cuda"][2] - out["cpu"][2]) <= 2


def test_zero_rhs_group_solve_through_the_graph(iaea_1x1_f32):
    """A zero right-hand side (a group without source in a source-only
    solve): the captured CG stops at once with x = 0, no NaN, and so does a
    second solve that replays the same graph; the eager block loop agrees."""
    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_plan, group_solve

    bench, spec = iaea_1x1_f32
    run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32)
    fes, ctx = run.solver._fes, run.solver._ctx
    ctx[krylov.CG_PLANS] = krylov.CGPlans()
    ctxg = ctx_group(ctx, 0)
    opts = SolveOptions(inner_tol=1e-5)
    rhs = torch.zeros(ctx["C"].shape[1:], dtype=torch.float32, device="cuda")
    for x0 in (torch.zeros_like(rhs), torch.ones_like(rhs)):
        got = group_solve(fes, ctxg, opts, rhs, x0)
        assert got.iterations == 0
        assert torch.equal(got.x, torch.zeros_like(rhs))
        assert bool(torch.isfinite(got.residual)) and float(got.residual) == 0.0
    plan = group_plan(fes, ctxg, opts, rhs)
    assert plan.graph.graph is not None
    want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                       tol=opts.inner_tol, maxiter=opts.max_inner, block=krylov.BLOCK_ITERS,
                       **plan.kwargs())
    assert want.iterations == 0 and not want.x.any()


def test_set_bc_rounds_free_the_replaced_plans(iaea_1x1_f32):
    """Two rounds of ``set_bc`` (MIRROR on the lower x face, where the first
    solve had DIRICHLET) and a solve on one facade: each round's context is
    rebuilt, the replaced context's CG plans become unreachable, and the
    second round ends at the allocated memory of the first."""
    import gc
    import weakref

    from neutfem_tpu_torch import krylov

    bench, spec = iaea_1x1_f32
    s = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32).solver
    s.set_tol(1e-5, 1e-4, 1e-4, 200, 1000)
    s.SolveKeff()
    after = []
    for _ in range(2):
        plans = weakref.ref(s._ctx[krylov.CG_PLANS])
        s.set_bc(3, 2)
        s.reset_flux()
        s.SolveKeff()
        assert krylov.CG_PLANS in s._ctx and s._ctx[krylov.CG_PLANS] is not plans()
        gc.collect()
        torch.cuda.synchronize()
        assert plans() is None
        after.append(torch.cuda.memory_allocated())
    assert after[1] == after[0]


# last in the file: a failed capture must leave nothing behind for later tests
def test_cg_graph_capture_failure_raises(cuda):
    """An operator that reads the device from the host cannot be captured:
    the solve raises, with no eager fallback."""
    from neutfem_tpu_torch import krylov

    A, b, x0, _ = _spd(16, cuda)

    def matvec(x):
        float(x[0])  # a host read: illegal while the stream is captured
        return A @ x

    with pytest.raises(RuntimeError):
        krylov.pcg(matvec, b, x0, tol=1e-10)
