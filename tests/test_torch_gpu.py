"""Card-only tests of neutfem_tpu_torch's CUDA kernels against their plain versions.

Each test compares one hand-written kernel (the tiled K1 / K2 / K3 kernel and its
group-batched form, K1's batch and K5; the tiled K4, the tiled K4′, the tiled K6,
the tiled K7, the tiled K8 on its three storage forms) with the plain PyTorch version
of the same function, on the card, at a small shape; the last tests hold the CG's
captured blocks (``krylov.CGGraph``) against the eager block loop on the card, and
the CG step's two kernels (``ops/cgstep``) against their plain versions bit for bit,
alone and inside a group solve, and the capture rule of every ``tracing`` counter
(counted again at each replay), then the facade's paths on the card: the Anderson solve against the CPU, a zero
right-hand side through a captured CG, and the plans of a context that ``set_bc``
replaced freed with it; last the NCCL world of one: the sharded solve, the
sharded CG, BiCGSTAB and Jacobi-sweep graphs against their eager block loops,
and the scan cut-axis solve against the CPU's and in a captured graph; then
the program's synchronisation sites (``tracing.sync``) against the
synchronising runtime calls of a profiled solve, the block-Jacobi
preconditioner built on the card against the CPU's build, and the line
preconditioner's counter against K4's launches at IAEA-3D 8x8x8.  They need a CUDA device and
skip without one (the decision is made inside a fixture, at run time).  This
file imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from neutfem_tpu_torch import fespace, mesh, tracing
from neutfem_tpu_torch.bench import reset_cg_counts
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


def _counts(prefix):
    """``tracing``'s totals under ``prefix`` (a kernel module's launches)."""
    return {k: v for k, v in tracing.totals().items() if k.startswith(prefix)}


def _moved(prefix, before):
    """The counters under ``prefix`` that moved since the totals ``before``
    (``_counts``), by how much."""
    return {k: v - before.get(k, 0) for k, v in _counts(prefix).items()
            if v != before.get(k, 0)}


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
    before = _counts("fused.")
    got = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert _moved("fused.", before) == {"fused.z_rows": 1}


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
    with CUDA's message (``cuda_lib.check``: no fallback), and nothing is
    counted."""
    v, acc, t = _operands((25000, 1, 2), torch.float64, cuda, 62)
    dm, l = t(25001, 1, 2, lo=0.2, hi=0.6), t(25000, 1, 2, lo=-0.3, hi=0.3)
    before = _counts("fused.")
    with pytest.raises(RuntimeError,
                       match=r"tiled kernel.*CUDA launch failed with error \d+ \(\w.*\)"):
        fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    assert _moved("fused.", before) == {}


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
    under thomas.thomas_wide_rows alone."""
    assert thomas.wide_rows(shape, -2)
    rng = np.random.default_rng(4)
    lshape = list(shape)
    lshape[-2] -= 1
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    dinv = torch.as_tensor(rng.uniform(0.3, 0.5, shape), dtype=dtype, device=cuda)
    l = torch.as_tensor(rng.uniform(-0.4, 0.4, lshape), dtype=dtype, device=cuda)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -2)
    before = _counts("thomas.")
    got = thomas.thomas_solve(rhs, dinv, l, -2)
    torch.cuda.synchronize()
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]
    assert _moved("thomas.", before) == {"thomas.thomas_wide_rows": 1}


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
    counted) under its own key alone."""
    v, acc, staged, nat, axis = _rows_operands(key, shape, dtype, cuda, 30)
    want = fused.fused_dir_plain(acc, v, *nat, axis, 0.5, -0.5, 0.25)
    before = _counts("fused.")
    got = ROWS[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert _moved("fused.", before) == {f"fused.{key}_rows": 1}


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
    wrapper raises (no fallback); the error does not leak into the next
    launch."""
    v, acc, staged, nat, axis = _rows_operands("x", (1, 1, 25000), torch.float64, cuda, 32)
    before = _counts("fused.")
    with pytest.raises(RuntimeError, match="tiled kernel"):
        fused.fused_schur_x_pre(acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    assert _moved("fused.", before) == {}
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
    before = _counts("fused.")
    got = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert _moved("fused.", before) == {f"fused.{key}_batched_rows": 1}


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
    before = _counts("fused.")
    got = BATCHED[key](acc.clone(), v, *staged, 0.5, -0.5, 0.25)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    assert _moved("fused.", before) == {f"fused.{key}_batched_rows": 1}


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
    """The tiled K6 kernel, counted under its own key alone."""
    tabs, v, acc, staged, nat = _ho_operands(k, axis, dtype, cuda, 10 * k + axis)
    want = fused_ho.fused_ho_plain(acc, v, *nat, axis - 3, tabs)
    before = _counts("fused_ho.")
    got = HO[axis](acc.clone(), v, *staged, tabs)
    torch.cuda.synchronize()
    assert _rel(got, want, acc) <= TOL[dtype]
    key = ("ho_z", "ho_y", "ho_x")[axis]
    assert _moved("fused_ho.", before) == {f"fused_ho.{key}_rows": 1}


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
    refused by the card and the wrapper raises, counting nothing (no
    fallback); the next launch succeeds."""
    tabs, v, acc, staged, _ = _ho_operands(2, 2, torch.float64, cuda, 71, (1, 1, 8000))
    assert fused_ho.ho_smem(8000, *fused_ho.ho_tile(1, 8000, 3, torch.float64), 3, 8) > \
        fused_ho.SMEM_PER_BLOCK
    before = _counts("fused_ho.")
    with pytest.raises(RuntimeError, match="tiled kernel"):
        fused_ho.fused_ho_x(acc.clone(), v, *staged, tabs)
    assert _moved("fused_ho.", before) == {}
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

    before = _counts("fused_eq.")
    got, got_u = run(cuda)
    torch.cuda.synchronize()
    assert _moved("fused_eq.", before) == {f"fused_eq.{key}_rows": 1}
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
    before = _counts("blockjac.")
    z, rz, rr = blockjac.blockjac_dots(bi, r)
    torch.cuda.synchronize()
    assert _moved("blockjac.", before) == {"blockjac.blockjac_tiled": 1}
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
    before = _counts("blockjac.")
    got = blockjac.blockjac_dev_dots(dev, r)
    torch.cuda.synchronize()
    assert _moved("blockjac.", before) == {"blockjac.blockjac_dev": 1}
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
    association; counted under thomas.thomas_rows alone."""
    rhs, dinv, l = _thomas_operands(shape, axis, dtype, cuda, 20)
    before = _counts("thomas.")
    got = thomas.thomas_solve(rhs, dinv, l, axis)
    torch.cuda.synchronize()
    assert _moved("thomas.", before) == {"thomas.thomas_rows": 1}
    want = thomas.thomas_solve_plain(rhs, dinv, l, axis)
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]


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
    before = _counts("thomas.")
    with pytest.raises(RuntimeError, match="tiled kernel"):
        thomas.thomas_solve(rhs, dinv, l, -2)
    assert _moved("thomas.", before) == {}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1, 1, 913, 912),   # ZION 48x48 compute_current y
                                   (4, 1, 1, 545, 544),   # KOEBERG 32x32
                                   (1, 1, 912, 912),      # the ZION line preconditioner
                                   (3, 1, 1, 1, 70000)])  # n = 1
def test_thomas_wide_rows_kernel_matches_plain_at_the_paths_shapes(cuda, dtype, shape):
    """The tiled K4′ at the paths' shapes against the plain version: rel
    1e-12 (float64) / 1e-5 (float32)."""
    assert thomas.wide_rows(shape, -2)
    rhs, dinv, l = _thomas_operands(shape, -2, dtype, cuda, 30)
    got = thomas.thomas_solve(rhs, dinv, l, -2)
    want = thomas.thomas_solve_plain(rhs, dinv, l, -2)
    assert _rel(got, want, torch.zeros_like(want)) <= TOL[dtype]


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
    before = _counts("thomas.")
    with pytest.raises(ValueError, match="K4′"):
        thomas.thomas_solve(rhs, dinv, l, -2)
    assert _moved("thomas.", before) == {}


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
    reset_cg_counts()
    got = run(lambda x: A @ x, b, x0, **kw)
    reads = tracing.total("cg.host_reads")
    want = blocks(lambda x: A @ x, b, x0, block=krylov.BLOCK_ITERS, **kw)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x) and torch.equal(got.residual, want.residual)
    assert reads == max(1, -(-got.iterations // krylov.BLOCK_ITERS))
    assert tracing.total("cg.captures") == 1


def test_cg_graph_is_reused_and_counts_launches(cuda):
    """A CGGraph kept across solves is captured once; the kernel counters
    add the captured block's launches at every replay (the capture itself
    adds none): the operator is a K4 Thomas solve (T^-1, SPD)."""
    from neutfem_tpu_torch import krylov

    shape = (1, 20, 8, 8)
    rhs, dinv, l = _thomas_operands(shape, -3, torch.float64, cuda, 41)
    matvec = lambda x: thomas.thomas_solve(x, dinv, l, -3)
    graph = krylov.CGGraph()
    reset_cg_counts()
    first = krylov.pcg(matvec, rhs, torch.zeros_like(rhs), tol=1e-10, graph=graph)
    for seed in (42, 43):
        b = _thomas_operands(shape, -3, torch.float64, cuda, seed)[0]
        before = tracing.total("thomas.thomas_rows")
        replays = tracing.total("cg.replays")
        got = krylov.pcg(matvec, b, torch.zeros_like(b), tol=1e-10, graph=graph)
        replays = tracing.total("cg.replays") - replays
        assert replays == -(-got.iterations // krylov.BLOCK_ITERS)
        # the prologue's matvec, then BLOCK_ITERS matvecs a replay
        assert tracing.total("thomas.thomas_rows") - before == 1 + replays * krylov.BLOCK_ITERS
        want = krylov.pcg_blocks(matvec, b, torch.zeros_like(b), tol=1e-10)
        assert got.iterations == want.iterations > 3 and torch.equal(got.x, want.x)
    assert tracing.total("cg.captures") == 1 and first.iterations > 3


def test_cg_graph_capture_survives_a_collection(cuda):
    """A dead graph held in a reference cycle (a dropped plan's) becomes
    garbage while a CG is captured, and enough objects are made to start
    the cyclic collector: the capture holds it off (collecting there would
    destroy the dead graph inside the capture and invalidate it), and the
    solve gives the eager block loop's bits."""
    import gc

    from neutfem_tpu_torch import krylov

    A, b, x0, _ = _spd(48, cuda)
    holder = [krylov.CGGraph()]
    krylov.pcg(lambda x: A @ x, b, x0, tol=1e-10, graph=holder[0])  # a graph to drop

    def matvec(x):
        if holder and torch.cuda.is_current_stream_capturing():
            cycle = {"graph": holder.pop()}
            cycle["self"] = cycle
            del cycle  # only the collector frees it now
            junk = [[] for _ in range(5 * gc.get_threshold()[0])]  # a collection's worth
            del junk
        return A @ x

    got = krylov.pcg(matvec, b, x0, tol=1e-10, graph=krylov.CGGraph())
    assert not holder
    want = krylov.pcg_blocks(lambda x: A @ x, b, x0, tol=1e-10, block=krylov.BLOCK_ITERS)
    assert got.iterations == want.iterations and torch.equal(got.x, want.x)


# --- the CG step's kernels (ops/cgstep.py) -----------------------------------

CG_MAXITER = 9


def _cg_operands(n, dtype, device, case, seed, shift=0):
    """A CG state's vectors (x, r, p, q, z, the preconditioner's m) and 0-d
    operands for ``case``; ``shift``: every vector starts that many values
    into its buffer (no 16-byte alignment)."""
    rng = np.random.default_rng(seed)

    def vec():
        buf = torch.empty(n + shift, dtype=dtype, device=device)
        out = buf[shift:]
        out.copy_(torch.as_tensor(rng.standard_normal(n), dtype=dtype))
        return out

    s = lambda v, dt=dtype: torch.tensor(v, dtype=dt, device=device)
    vecs = [vec() for _ in range(6)]
    pq = s(torch.finfo(dtype).tiny / 2 if case == "breakdown" else rng.uniform(0.5, 2.0))
    rz = s(-0.0 if case == "rz_zero" else rng.uniform(0.5, 2.0))
    rr = s(rng.uniform(0.5, 2.0))
    it = s(CG_MAXITER - 1 if case == "maxiter" else 3, torch.int32)
    go = s(case != "frozen", torch.bool)
    tol_sq = s(0.25, torch.float64 if case == "tol_f64" else dtype)
    return vecs, (pq, rz, rr, it, go, tol_sq)


def _cg_step_pair(form, xr, p_fn, vecs, scalars):
    """One step's two halves through (xr, p_fn), the dots between them as
    the CG takes them for ``form``."""
    x, r, p, q, _, m = vecs
    pq, rz, rr, it, go, tol_sq = scalars
    x1, r1, r2 = xr(x, r, p, q, pq, rz, go, rr=form != "precond_dots")
    z = r1 if form == "none" else m * r1
    rr_new = torch.sum(r1 * r1) if r2 is None else torch.sum(r2)
    rz_new = rr_new if form == "none" else torch.sum(r1 * z)
    return (x1, r1, r2, *p_fn(z, p, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, CG_MAXITER))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", ["none", "precond", "precond_dots"])
@pytest.mark.parametrize("case", ["live", "frozen", "breakdown", "rz_zero", "maxiter", "tol_f64"])
@pytest.mark.parametrize("n,shift", [(4096, 0), (1027, 0), (1027, 1), (3_000_017, 0)],
                         ids=["aligned", "ragged", "unaligned", "large"])
def test_cg_step_kernels_match_plain(cuda, dtype, form, case, n, shift):
    """cg_xr / cg_p against their plain versions on the card, bit for bit:
    x, r, r * r, p, rz, rr, it and go, from a live state, a frozen one, a
    breakdown (|pq| <= tiny), rz = -0 (read as 1), it reaching maxiter and a
    float64 tol_sq; 16-byte vectors, a ragged tail, unaligned pointers (one
    value at a time) and a length of several grid strides."""
    from neutfem_tpu_torch.ops import cgstep

    vecs, scalars = _cg_operands(n, dtype, cuda, case, 70, shift)
    before = _counts("cgstep.")
    got = _cg_step_pair(form, cgstep.cg_xr, cgstep.cg_p, vecs, scalars)
    want = _cg_step_pair(form, cgstep.cg_xr_plain, cgstep.cg_p_plain, vecs, scalars)
    torch.cuda.synchronize()
    assert _moved("cgstep.", before) == {"cgstep.cg_xr": 1, "cgstep.cg_p": 1}
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), i
    go = bool(got[-1])
    assert go == (case in ("live", "rz_zero", "tol_f64")), case


def test_cg_step_kernels_are_deterministic(cuda):
    from neutfem_tpu_torch.ops import cgstep

    vecs, scalars = _cg_operands(3_000_017, torch.float32, cuda, "live", 71)
    one = _cg_step_pair("precond", cgstep.cg_xr, cgstep.cg_p, vecs, scalars)
    two = _cg_step_pair("precond", cgstep.cg_xr, cgstep.cg_p, vecs, scalars)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_cg_step_kernels_reject_what_they_do_not_take(cuda):
    """A strided vector, float16, a 0-d operand of another dtype or on the
    host, a float go, an int64 it or a host tol_sq raise before a launch."""
    from neutfem_tpu_torch.ops import cgstep

    vecs, (pq, rz, rr, it, go, tol_sq) = _cg_operands(64, torch.float32, cuda, "live", 72)
    x, r, p, q, z, _ = vecs
    before = _counts("cgstep.")
    big = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError):
        cgstep.cg_xr(big[::2], r, p, q, pq, rz, go)
    with pytest.raises(TypeError):
        cgstep.cg_xr(x.half(), r.half(), p.half(), q.half(), pq.half(), rz.half(), go)
    with pytest.raises(ValueError):
        cgstep.cg_xr(x, r, p, q[:32], pq, rz, go)
    with pytest.raises(ValueError):
        cgstep.cg_xr(x, r, p, q, pq.double(), rz, go)
    with pytest.raises(ValueError):
        cgstep.cg_xr(x, r, p, q, pq.cpu(), rz, go)
    with pytest.raises(ValueError):
        cgstep.cg_xr(x, r, p, q, pq, rz, go.float())
    with pytest.raises(ValueError):
        cgstep.cg_p(z, p, pq, rz, rz, rr, rr, it.long(), go, tol_sq, CG_MAXITER)
    with pytest.raises(ValueError):
        cgstep.cg_p(z, p, pq, rz, rz, rr, rr, it, go, tol_sq.cpu(), CG_MAXITER)
    assert _moved("cgstep.", before) == {}


def test_cg_step_launches_count_under_graph_replay(cuda):
    """A replay adds its captured block's cg_xr / cg_p launches (one each an
    iteration, frozen ones included); the capture adds its eager warm-up
    step's, nothing of the captured block."""
    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.ops import cgstep

    A, b, x0, minv = _spd(48, cuda)
    graph = krylov.CGGraph()
    for first in (True, False):
        reset_cg_counts()
        before = _counts("cgstep.")
        res = krylov.pcg(lambda x: A @ x, b, x0, precond=lambda r: minv * r, tol=1e-10,
                         graph=graph)
        replays = tracing.total("cg.replays")
        assert replays == -(-res.iterations // krylov.BLOCK_ITERS) and replays > 2
        moved = _moved("cgstep.", before)
        for k in ("cg_xr", "cg_p"):
            assert moved[f"cgstep.{k}"] == first + replays * krylov.BLOCK_ITERS


def test_a_counter_in_a_captured_step_counts_at_every_replay(cuda, monkeypatch):
    """The capture rule of ``krylov.CGGraph``, one for every ``tracing``
    counter: a counter counted inside the CG step (here in the
    preconditioner) reads once for the prologue's call, once for the
    capture's warm-up step and BLOCK_ITERS for each replay; the capture
    itself adds nothing, and a graph kept across solves captures once.  Then
    the line preconditioner (IAEA-3D 1x1x1 float32; its CG graphs captured
    in the first solve, replayed in the second): the solve record's
    ``precond.line_applies`` is K4's launches less ``compute_current``'s
    three."""
    from neutfem_tpu_torch import krylov, power
    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS

    A, b, x0, minv = _spd(48, cuda)

    def precond(r):
        tracing.count("test.step")
        return minv * r

    graph = krylov.CGGraph()
    for first in (True, False):
        with tracing.collect() as c:
            res = krylov.pcg(lambda x: A @ x, b, x0, precond=precond, tol=1e-10, graph=graph)
        got = c.record["counters"]
        replays = got["cg.replays"]
        assert replays == -(-res.iterations // krylov.BLOCK_ITERS) and replays > 2
        assert got.get("cg.captures", 0) == int(first)
        assert got["test.step"] == 1 + first + replays * krylov.BLOCK_ITERS

    monkeypatch.setenv("NEUTFEM_PRECOND", "line")
    s = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cuda", dtype=torch.float32).solver
    assert s.preconditioner() == "line"
    for first in (True, False):
        s.reset_flux()
        s.SolveKeff()
        rec = tracing.recent(1)[0]
        counters = rec["counters"]
        assert (counters.get("cg.captures", 0) > 0) == first
        currents = rec["spans"]["neutfem.current"][0]
        assert counters[power.LINE_APPLIES] == counters["thomas.thomas_rows"] - 3 * currents
        assert counters[power.LINE_APPLIES] >= counters["cg.solves"] + counters["cg.iterations_run"]


@pytest.fixture(scope="module")
def iaea_1x1_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neutfem_tpu_torch import bench
    from neutfem_tpu_torch.data import BENCHMARKS

    spec = BENCHMARKS["iaea3d"]
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


@pytest.mark.parametrize("case", ["rt0", "rt1", "jacobi"])
def test_group_solve_kernel_step_matches_plain_step(iaea_1x1_f32, case, monkeypatch):
    """group_solve through the CG step's kernels against the same solve with
    the step's plain versions put in their place (each captured afresh),
    IAEA-3D 1x1 float32: the same x, iterations and residual, bit for bit,
    on the Jacobi-equilibrated RT0 path (no preconditioner), RT1-P1 (K8's
    apply + dots) and the Jacobi sweep's batched solve."""
    from neutfem_tpu_torch import krylov
    from neutfem_tpu_torch.ops import cgstep
    from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_solve

    bench, spec = iaea_1x1_f32
    run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32,
                             rt_order=1 if case == "rt1" else 0)
    fes, ctx = run.solver._fes, run.solver._ctx
    opts = SolveOptions(inner_tol=1e-5)
    shape = ctx["C"].shape if case == "jacobi" else ctx["C"].shape[1:]
    rhs = torch.as_tensor(np.random.default_rng(46).standard_normal(shape), dtype=torch.float32,
                          device="cuda")

    def solve():
        ctx[krylov.CG_PLANS] = krylov.CGPlans()  # a new plan: captured with today's step
        ctxg = ctx if case == "jacobi" else ctx_group(ctx, 0)
        return group_solve(fes, ctxg, opts, rhs, torch.zeros_like(rhs))

    before = _counts("cgstep.")
    got = solve()
    moved = _moved("cgstep.", before)
    assert set(moved) == {"cgstep.cg_xr", "cgstep.cg_p"} and min(moved.values()) > got.iterations
    monkeypatch.setattr(cgstep, "cg_xr", cgstep.cg_xr_plain)
    monkeypatch.setattr(cgstep, "cg_p", cgstep.cg_p_plain)
    before = _counts("cgstep.")
    want = solve()
    assert _moved("cgstep.", before) == {}
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x) and torch.equal(got.residual, want.residual)


@pytest.mark.parametrize("case", ["bicgstab", "bicgstab_rt1", "periodic", "periodic_rt1",
                                  "diag"])
def test_new_paths_graph_matches_eager_blocks(iaea_1x1_f32, case):
    """The paths of the diagonal A-solve, PERIODIC and BiCGSTAB on the card:
    group_solve through its plan's captured graph against the eager block
    loop, IAEA-3D 1x1 float32 (the lateral faces PERIODIC: the cyclic solve on
    K4 in x and y; BiCGSTAB with K8's apply at RT1-P1): the same bits and
    count."""
    from neutfem_tpu_torch.compat import BCType
    from neutfem_tpu_torch.power import SolveOptions

    bench, spec = iaea_1x1_f32
    bc = ({f: (BCType.PERIODIC, 0.0) for f in bench.LATERAL} if case.startswith("periodic")
          else None)
    run = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32,
                             rt_order=1 if case.endswith("rt1") else 0, bc=bc)
    s = run.solver
    opts = SolveOptions(inner_tol=1e-5, a_mode="diag" if case == "diag" else "exact",
                        inner_solver="bicgstab" if case.startswith("bicgstab") else "cg")
    before = tracing.total("thomas.thomas_rows")
    got, want = _graph_vs_eager(s._fes, s._context(opts.a_mode), opts, 0)
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x)
    launched = tracing.total("thomas.thomas_rows") - before
    assert (launched > 0) == case.startswith("periodic")


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
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.power import SolveOptions

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUTFEM_PRECOND", "twogrid")
        run = bench.BenchmarkRun(BENCHMARKS["koeberg2d"], 4,
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


def test_set_bc_rounds_free_both_contexts_plans(iaea_1x1_f32):
    """The facade with two contexts on the card (the exact one and the
    diagonal solver's): two rounds of ``set_bc`` and both solves; each
    round drops both replaced contexts' CG plans, and the second round ends
    at the allocated memory of the first."""
    import gc
    import weakref

    from neutfem_tpu_torch import krylov

    bench, spec = iaea_1x1_f32
    s = bench.BenchmarkRun(spec, 1, 1, device="cuda", dtype=torch.float32).solver
    s.set_tol(1e-5, 1e-4, 1e-4, 200, 1000)
    s.SolveKeff(use_diagonal_solver=True)
    s.SolveKeff()
    after = []
    for _ in range(2):
        plans = [weakref.ref(c[krylov.CG_PLANS]) for c in (s._ctx, s._ctxs["diag"])]
        s.set_bc(3, 2)
        s.reset_flux()
        s.SolveKeff(use_diagonal_solver=True)
        s.reset_flux()
        s.SolveKeff()
        gc.collect()
        torch.cuda.synchronize()
        assert all(p() is None for p in plans)
        after.append(torch.cuda.memory_allocated())
    assert after[1] == after[0]


@pytest.fixture(scope="module")
def nccl_mesh():
    """The NCCL world of one (``parallel.device_mesh``), for the module's
    sharded tests; destroyed after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from neutfem_tpu_torch import parallel

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = parallel.device_mesh("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                                world_size=1)
    yield mesh
    dist.destroy_process_group()


def _sharded_problem(mesh, dtype):
    """A heterogeneous 3D core (``torch_dist_cases.core3d``, 16x12x8) on the
    card: (fes, ng, the rank's z-cut context, the unsharded context)."""
    import torch_dist_cases as dc

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.ops.context import build_host_context, context_to_device

    fes, ng, xs, bcs = dc.port_problem(dc.core3d(16, 12, 8))
    host = build_host_context(fes, ng, xs, bcs)
    ctx = parallel.shard_context(host, mesh, fes, 0, device="cuda", dtype=dtype)
    return fes, ng, ctx, context_to_device(*host, fes.P, "cuda", dtype)


def test_nccl_world_of_one_sharded_solve_matches_unsharded(nccl_mesh):
    """The NCCL world of one, z cut: the partitioned solve, the collectives
    and the graph-replayed CG give the unsharded solve's k within float32
    rounding, its outer count and its flux."""
    from neutfem_tpu_torch import krylov, parallel
    from neutfem_tpu_torch.ops import parttri
    from neutfem_tpu_torch.power import SolveOptions, power_iteration

    fes, ng, ctx, full = _sharded_problem(nccl_mesh, torch.float32)
    opts = SolveOptions(tol_keff=1e-6, tol_flux=1e-5, inner_tol=1e-6, max_outer=100)
    phi0 = torch.ones((ng, *fes.mesh.shape, 1), dtype=torch.float32, device="cuda")
    want = power_iteration(fes, ng, opts, full, phi0, 1.0)
    run, _ = parallel.sharded_power_iteration(fes, ng, opts, nccl_mesh, 0)
    reset_cg_counts()
    before = tracing.total(parttri.PARTTRI)
    got = run(ctx, parallel.shard_state(phi0, nccl_mesh, 0), 1.0)
    assert got["sharding"]["cg"] == "graph" and tracing.total("cg.replays") > 0
    assert tracing.total(parttri.PARTTRI) - before >= got["inner_iterations"]
    assert abs(float(got["keff"]) - float(want["keff"])) <= 2e-6
    assert got["outer_iterations"] == want["outer_iterations"]
    phi = parallel.gather_state(got["phi"], nccl_mesh, 0)
    assert _rel(phi, want["phi"], torch.zeros_like(phi)) <= 1e-4


def test_sharded_graph_equals_eager_under_nccl(nccl_mesh):
    """One group solve under the NCCL scope: the captured graph (its
    collectives inside) and the eager block loop give the same bits and
    count."""
    from neutfem_tpu_torch import krylov, parallel
    from neutfem_tpu_torch.power import SolveOptions, _fission_source, ctx_group, group_plan, \
        group_solve
    from neutfem_tpu_torch.shardctx import sharding_scope

    fes, ng, ctx, _ = _sharded_problem(nccl_mesh, torch.float32)
    ctx[krylov.CG_PLANS] = krylov.CGPlans()
    ctxg = ctx_group(ctx, 0)
    opts = SolveOptions(inner_tol=1e-6)
    phi = torch.ones((ng, 1, 16, 12, 8), dtype=torch.float32, device="cuda")  # one rank: all
    with sharding_scope(nccl_mesh, {0: parallel.SPATIAL_AXIS}):
        rhs = ctx["chi"][0] * _fission_source(ctx, phi)
        x0 = torch.zeros_like(rhs)
        group_solve(fes, ctxg, opts, rhs, x0)  # the capture
        reset_cg_counts()
        got = group_solve(fes, ctxg, opts, rhs, x0)
        assert tracing.total("cg.replays") >= 1 and tracing.total("cg.captures") == 0
        plan = group_plan(fes, ctxg, opts, rhs)
        want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                           tol=opts.inner_tol, maxiter=opts.max_inner,
                           block=krylov.BLOCK_ITERS, **plan.kwargs())
    assert got.iterations == want.iterations > 3
    assert torch.equal(got.x, want.x * plan.sdi)


@pytest.mark.parametrize("variant", ["bicgstab", "jacobi_sweep"])
def test_sharded_variant_graph_equals_eager_under_nccl(nccl_mesh, variant):
    """BiCGSTAB (one group, float64) and the Jacobi sweep's batched CG
    (every group, float32) under the NCCL scope: the captured graph, with its
    collectives and the partitioned solve inside, gives the eager block
    loop's bits and count, and each replay adds its capture's counts (the
    collectives and the partitioned-solve applications of a solve equal the
    eager loop's, block for block)."""
    from neutfem_tpu_torch import krylov, parallel
    from neutfem_tpu_torch.ops import parttri
    from neutfem_tpu_torch.power import SolveOptions, _fission_source, ctx_group, group_plan, \
        group_solve
    from neutfem_tpu_torch.shardctx import sharding_scope

    dtype = torch.float64 if variant == "bicgstab" else torch.float32
    fes, ng, ctx, _ = _sharded_problem(nccl_mesh, dtype)
    ctx[krylov.CG_PLANS] = krylov.CGPlans()
    opts = SolveOptions(inner_tol=1e-6, inner_solver="bicgstab" if variant == "bicgstab"
                        else "cg", sweep="jacobi" if variant == "jacobi_sweep" else "gs")
    phi = torch.ones((ng, 1, 16, 12, 8), dtype=dtype, device="cuda")  # one rank: all
    with sharding_scope(nccl_mesh, {0: parallel.SPATIAL_AXIS}):
        fiss = _fission_source(ctx, phi)
        if variant == "jacobi_sweep":
            ctxg, rhs = ctx, ctx["chi"].unsqueeze(-4) * fiss
        else:
            ctxg, rhs = ctx_group(ctx, 0), ctx["chi"][0] * fiss
        x0 = torch.zeros_like(rhs)
        group_solve(fes, ctxg, opts, rhs, x0)  # the capture

        def counts():
            return tracing.total("comm.collectives"), tracing.total(parttri.PARTTRI)

        reset_cg_counts()
        c0 = counts()
        got = group_solve(fes, ctxg, opts, rhs, x0)
        c1 = counts()
        assert tracing.total("cg.replays") >= 1 and tracing.total("cg.captures") == 0
        assert tracing.total("cg.eager_solves") == 0
        plan = group_plan(fes, ctxg, opts, rhs)
        want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                           tol=opts.inner_tol, maxiter=opts.max_inner,
                           block=krylov.BLOCK_ITERS, **plan.kwargs())
        c2 = counts()
    assert got.iterations == want.iterations > 3
    assert torch.equal(got.x, want.x * plan.sdi)
    graph_counts = (c1[0] - c0[0], c1[1] - c0[1])
    assert graph_counts == (c2[0] - c1[0], c2[1] - c1[1])
    assert graph_counts[0] > 0 and graph_counts[1] >= got.iterations


@pytest.mark.parametrize("cyclic", [False, True])
def test_scan_cut_solve_on_the_card_matches_the_cpu(nccl_mesh, cyclic):
    """The scan cut-axis solve (``parttri.tridiag_solve_scan``) on the NCCL
    world of one, float64: its two sweeps with the seam face (or, on a
    PERIODIC direction, the folded system's Sherman-Morrison correction) on
    CUDA tensors against the same system through the CPU's ``scan_solve``;
    captured in a CUDA graph (its all-gathers inside, as the CG captures
    them), the replay gives the eager bits."""
    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.native import tridiag_ldlt_batch
    from neutfem_tpu_torch.ops import parttri
    from neutfem_tpu_torch.ops.tridiag import scan_solve

    rng = np.random.default_rng(15 + cyclic)
    n = 37 if cyclic else 38  # faces: the folded system's n, or n = 37 body faces and the seam
    dinv, l = tridiag_ldlt_batch(rng.uniform(2.5, 4.0, (4, 3, n)),
                                 rng.uniform(-1.0, -0.2, (4, 3, n - 1)))
    dinv, l = np.moveaxis(dinv, -1, 1), np.moveaxis(l, -1, 1)  # (4, faces, 3): face axis 1
    rhs = rng.standard_normal((4, 2, n, 3))  # (batch, T, faces, 3): face axis 2
    cpu = {k: torch.as_tensor(v).unsqueeze(1) for k, v in (("dinv", dinv), ("l", l))}
    want = scan_solve(torch.as_tensor(rhs), cpu["dinv"], cpu["l"], 2)
    cyc = None
    if cyclic:
        cyc = tuple(torch.as_tensor(rng.uniform(-0.5, 0.5, sh)).unsqueeze(1)
                    for sh in ((4, n, 3), (4, 1, 3), (4, 1, 3)))
        wt, a0, a1 = cyc
        want = want - wt * (a0 * want[:, :, :1] + a1 * want[:, :, n - 1:])
    body = n if cyclic else n - 1
    lpad = np.concatenate([l, np.zeros_like(l[:, :1])], axis=1) if cyclic else l

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a), device="cuda").unsqueeze(1)

    r = torch.as_tensor(rhs, device="cuda")
    args = (r[:, :, :body].contiguous(), None if cyclic else r[:, :, body:].contiguous(),
            (card(dinv[:, :body]), None if cyclic else card(dinv[:, body:])),
            (card(np.zeros_like(l[:, :1])), card(lpad[:, :body])), 2,
            nccl_mesh.axes[parallel.SPATIAL_AXIS],
            None if cyc is None else tuple(t.cuda() for t in cyc))
    x, x_seam = parttri.tridiag_solve_scan(*args)
    got = x if cyclic else torch.cat([x, x_seam], dim=2)
    assert _rel(got.cpu(), want, torch.zeros_like(want)) <= 1e-13
    # captured: the replay gives the eager bits
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        parttri.tridiag_solve_scan(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cx, _ = parttri.tridiag_solve_scan(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cx, x)


def test_transport_refuses_what_was_not_asked(nccl_mesh):
    """The backend is the caller's: the NCCL transport takes no CPU tensor
    (no gloo behind it), and a mesh over another backend than the running
    process group's is refused."""
    from neutfem_tpu_torch import parallel

    with pytest.raises(RuntimeError, match="nccl"):
        nccl_mesh.world.all_sum(torch.ones(()))
    with pytest.raises(RuntimeError, match="gloo"):
        parallel.device_mesh("gloo")
    assert nccl_mesh.world.capturable and nccl_mesh.backend == "nccl"


# --- the program's synchronisation sites (tracing) against the profiler -------

#: The runtime calls that block the host until the device has finished.
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")


@pytest.mark.parametrize("order,mesh_n,mesh_nz", [(0, 2, 2), (2, 1, 1)], ids=["rt0", "rt2"])
def test_sync_sites_are_the_profiled_synchronising_calls(cuda, order, mesh_n, mesh_nz):
    """The first solve of a facade (it captures the CG graphs and puts the
    constants on the card) and a cold solve after it, as the benchmark times
    it: the program's ``neutfem.sync.*`` spans are as many as the
    synchronising runtime calls the profiler saw inside its ``neutfem.solve``
    span, and whatever the profiler mirrors of the spans onto the device
    timeline is a user annotation, not device work."""
    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.bench import FULL_TOL, HO_TOL, BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS

    run = BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n, mesh_nz, device="cuda",
                       dtype=torch.float32, rt_order=order)
    s = run.solver
    s.set_tol(*(HO_TOL if order else FULL_TOL))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for first in (True, False):  # the warm-up captures a graph a group; the cold solve none
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            s.reset_flux()
            s.SolveKeff()
            torch.cuda.synchronize()
        rec = tracing.recent(1)[0]
        spans = rec["spans"]
        sites = sum(n for name, (n, _) in spans.items() if name.startswith(tracing.SYNC))
        events = prof.events()
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        solve = [e for e in host if e.name == tracing.SOLVE]
        assert len(solve) == 1
        lo, hi = solve[0].time_range.start, solve[0].time_range.end
        calls = [e for e in host if e.name in _SYNC_CALLS and lo <= e.time_range.start <= hi]
        assert rec["outers"] == s.GetLastOuterIterations() and spans[tracing.SOLVE][0] == 1
        assert spans.get("neutfem.sync.capture", (0, 0))[0] == (2 if first else 0)
        assert sites == len(calls), sorted({e.name for e in calls})
        # what the profiler mirrors of the spans onto the device is no device work
        mirrored = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith("neutfem.")]
        assert mirrored and all(getattr(e, "is_user_annotation", False) for e in mirrored)


def test_block_build_on_the_card_matches_the_cpu_and_its_span_covers_it(cuda):
    """The block-Jacobi preconditioner built on the card (``ops/context.
    _block_precond``) at IAEA-3D 2x2x2 RT2-P2 (54,872 cells) from the host's
    ingredients: its float32 fp8 E-form holds the CPU build's bytes, but
    where both are rounding noise of an exact zero
    (``blockjac_reference.assert_same_storage``), and its float64 inverse is
    the CPU's within 1e-12 of the largest entry.  The span
    ``neutfem.context.blockjac`` lasts at least the device time of the build
    (CUDA events just before and after the call; 1 ms for the host's steps
    between them and the span): it closes after the device work."""
    from blockjac_reference import assert_same_storage

    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.ops import context as ctx_mod

    run = BenchmarkRun(BENCHMARKS["iaea3d"], 2, 2, device="cpu", dtype=torch.float32,
                       rt_order=2)
    s = run.solver
    P = s._fes.P
    _, blk = ctx_mod.build_host_context(s._fes, s._ng, s._xs, s._bcs, marshak_d_factor=True)
    assert blk["fields"].shape[2:] == (38, 38, 38)
    cpu = ctx_mod._block_precond(blk, P, "cpu", torch.float32)
    ctx_mod._block_precond(blk, P, cuda, torch.float32)  # the libraries' first call
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with tracing.collect() as c:
        e0.record()
        card = ctx_mod._block_precond(blk, P, cuda, torch.float32)
        e1.record()
    torch.cuda.synchronize()
    assert list(card) == list(cpu) == ["precond_blk_dev"]
    assert_same_storage(card["precond_blk_dev"], cpu["precond_blk_dev"])
    span_s = c.record["spans"]["neutfem.context.blockjac"][1]
    device_s = e0.elapsed_time(e1) / 1e3
    assert span_s >= device_s - 1e-3, (span_s, device_s)
    assert c.record["counters"]["context.blockjac_blocks"] == 2 * 38 ** 3
    want = ctx_mod._block_precond(blk, P, "cpu", torch.float64)["precond_blk_inv"]
    got = ctx_mod._block_precond(blk, P, cuda, torch.float64)["precond_blk_inv"].cpu()
    assert float(torch.max(torch.abs(got - want))) <= 1e-12 * float(torch.max(torch.abs(want)))



def test_line_applies_are_the_line_launches_at_8x8x8(cuda):
    """IAEA-3D 8x8x8 (3,511,808 cells, the benchmark cell
    ``iaea3d-rt0p0-8x8x8.cold``): "auto" resolves to the line preconditioner,
    and over a solve (the first, which captures the CG graphs, then a cold
    one) the solve record's ``precond.line_applies`` is K4's launches less
    ``compute_current``'s three."""
    from neutfem_tpu_torch import power
    from neutfem_tpu_torch.bench import FULL_TOL, BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS

    s = BenchmarkRun(BENCHMARKS["iaea3d"], 8, 8, device="cuda", dtype=torch.float32).solver
    s.set_tol(*FULL_TOL)
    assert s._mesh.shape == (152, 152, 152) and s.preconditioner() == "line"
    for first in (True, False):
        s.reset_flux()
        s.SolveKeff()
        torch.cuda.synchronize()
        rec = tracing.recent(1)[0]
        currents = rec["spans"]["neutfem.current"][0]
        applies = rec["counters"][power.LINE_APPLIES]
        assert currents == 1 and (rec["counters"].get("cg.captures", 0) > 0) == first
        assert applies == rec["counters"]["thomas.thomas_rows"] - 3 * currents
        # a prologue's apply a CG, one an iteration the replays ran
        assert applies >= rec["counters"]["cg.solves"] + rec["counters"]["cg.iterations_run"]
        assert s.GetLastOuterIterations() < 200


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
