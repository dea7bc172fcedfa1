"""Card-only tests of neutfem_tpu_torch's CUDA kernels against their plain versions.

Each test compares one hand-written kernel (K1-K4) with the plain PyTorch
version of the same function, on the card, at a small shape.  They need a CUDA
device and skip without one (the decision is made inside a fixture, at run
time).  This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from neutfem_tpu_torch.ops import fused, thomas

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
    got = fused.fused_schur_z(acc.clone(), v, dm, l, 0.5, -0.5, 0.25)
    assert _rel(got, want, acc) <= TOL[dtype]


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


def test_kernels_reject_what_they_do_not_take(cuda):
    v = torch.zeros((1, 4, 5, 6), device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        fused.fused_schur_z(v, v, torch.zeros((5, 5, 6), device=cuda),
                            torch.zeros((4, 5, 6), device=cuda, dtype=torch.float64),
                            0.5, -0.5, 0.25)
    with pytest.raises(ValueError):
        thomas.thomas_solve(v, v, torch.zeros((1, 3, 5, 6), device=cuda).transpose(-1, -2),
                            -3)
