"""The plain PyTorch versions of the port's kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU (as tests/test_pallas_*.py do).

K1-K3 (ops/fused.py) against fused_schur_dir(axis=-3), fused_schur_y_pre and
fused_schur_x_pre; K4 (ops/thomas.py) against thomas_solve on the z, y and x
axes.  On a CPU tensor the port's wrappers run their plain version, so these
tests go through the wrappers (layout staging and in-place update included).
Tolerances: rel <= 1e-12 at float64 (the same recurrence, different rounding
only in the association of a few sums), rel <= 1e-5 at float32.
The kernels themselves are compared with these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.ops.pallas_fused import fused_schur_dir, fused_schur_x_pre, fused_schur_y_pre
from neutfem_tpu.ops.pallas_tridiag import thomas_solve as j_thomas_solve
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch.native import tridiag_ldlt_batch
from neutfem_tpu_torch.ops import fused, thomas
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.power import ctx_group

torch.set_num_threads(1)

TOL = {"f64": 1e-12, "f32": 1e-5}
DT = {"f64": (jnp.float64, torch.float64, np.float64),
      "f32": (jnp.float32, torch.float32, np.float32)}
SHAPE = (8, 64, 64)  # (nz, ny, nx): every JAX fused kernel engages here


def _rel(got, want, base):
    got, want, base = (np.asarray(a, dtype=np.float64) for a in (got, want, base))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


def _problem(prec):
    """JAX context (group 0) and the same operator as port tensors."""
    jdt, tdt, _ = DT[prec]
    rng = np.random.default_rng(0)
    nz, ny, nx = SHAPE
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (nx, ny, nz)])
    fes = j_fespace.make_fespace(mesh, 0, 0)
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *SHAPE)), "SigR": rng.uniform(0.01, 0.2, (ng, *SHAPE)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *SHAPE)), "Chi": np.ones((ng, *SHAPE)),
          "SigS": np.zeros((ng, ng, *SHAPE)), "SRC": np.zeros((ng, *SHAPE))}
    bcs = BCSpec()
    for ax in range(3):  # a MIRROR face on every direction, Marshak on the other
        bcs.set(j_mesh.boundary_attribute(3, ax, False), BCKind.MIRROR)
        bcs.set(j_mesh.boundary_attribute(3, ax, True), BCKind.DIRICHLET)
    jctx = j_build_context(fes, ng, xs, bcs, a_mode="exact", dtype=jdt)
    tctx = ctx_from_numpy({k: np.asarray(v) for k, v in jctx.items()}, "cpu", tdt)
    return fes, j_ctx_group(jctx, 0), ctx_group(tctx, 0), rng


@pytest.fixture(scope="module", params=["f64", "f32"])
def problem(request):
    return request.param, _problem(request.param)


@pytest.mark.parametrize("direction", ["z", "y", "x"])
def test_plain_fused_direction_matches_jax_interpret(problem, direction):
    prec, (fes, jctx, tctx, rng) = problem
    jdt, tdt, ndt = DT[prec]
    d = {"x": 0, "y": 1, "z": 2}[direction]
    di = [x for x in fes.dirs if x.d == d][0]
    bx0, bx1, si = float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0])
    v = rng.standard_normal((1, *SHAPE)).astype(ndt)
    acc = rng.standard_normal((1, *SHAPE)).astype(ndt)
    key = f"d{d}"
    if direction == "z":
        want = fused_schur_dir(jnp.asarray(acc), jnp.asarray(v),
                               jnp.expand_dims(jctx[f"tri_dinvm_{key}"], -4),
                               jnp.expand_dims(jctx[f"tri_l_{key}"], -4), -3,
                               bx0, bx1, si, interpret=True)
        dm, l, wrapper = tctx[f"tri_dinvm_{key}"], tctx[f"tri_l_{key}"], fused.fused_schur_z
    else:
        tag = "yT" if direction == "y" else "xT"
        jfn = fused_schur_y_pre if direction == "y" else fused_schur_x_pre
        want = jfn(jnp.asarray(acc), jnp.asarray(v), jctx[f"tri_{tag}_dinvm_{key}"],
                   jctx[f"tri_{tag}_l_{key}"], bx0, bx1, si, interpret=True)
        dm, l = tctx[f"tri_{tag}_dinvm_{key}"], tctx[f"tri_{tag}_l_{key}"]
        wrapper = fused.fused_schur_y_pre if direction == "y" else fused.fused_schur_x_pre
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    acc_t = torch.tensor(acc, dtype=tdt)
    got = wrapper(acc_t, torch.tensor(v, dtype=tdt), dm, l, bx0, bx1, si)
    assert got is acc_t  # updated in place, like the aliased TPU kernel
    assert _rel(got.numpy(), np.asarray(want), acc) <= TOL[prec]


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("shape,axis", [((2, 13, 7, 90), 1),   # z: solve axis -3
                                        ((4, 33, 150), 1),     # y: solve axis -2
                                        ((7, 90, 13), 2)])     # x: solve axis -1
def test_plain_thomas_matches_jax_interpret(prec, shape, axis):
    jdt, tdt, ndt = DT[prec]
    rng = np.random.default_rng(3)
    lshape = list(shape)
    lshape[axis] -= 1
    diag = rng.uniform(2.0, 3.0, shape)
    off = rng.uniform(-0.5, 0.5, lshape)
    dinv, l = (np.moveaxis(a, -1, axis) for a in tridiag_ldlt_batch(
        np.moveaxis(diag, axis, -1), np.moveaxis(off, axis, -1)))
    rhs, dinv, l = (a.astype(ndt) for a in (rng.standard_normal(shape), dinv, l))
    want = j_thomas_solve(jnp.asarray(rhs), jnp.asarray(dinv), jnp.asarray(l), axis,
                          interpret=True)
    assert want is not None
    got = thomas.thomas_solve(*(torch.tensor(np.ascontiguousarray(a), dtype=tdt)
                                for a in (rhs, dinv, l)), axis)
    assert _rel(got.numpy(), np.asarray(want), np.zeros(shape)) <= TOL[prec]


def test_wrappers_reject_batched_layouts():
    """The one-group wrappers raise on a batched (ng, P, ...) v instead of
    declining; the group-batched wrappers raise when the flux's and the
    operands' group counts disagree."""
    v = torch.zeros((2, 1, 4, 5, 6), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        fused.fused_schur_z(v, v, torch.zeros((5, 5, 6), dtype=torch.float64),
                            torch.zeros((4, 5, 6), dtype=torch.float64), 0.5, -0.5, 0.25)
    with pytest.raises(ValueError, match="groups"):
        fused.fused_schur_z_batched(v, v, torch.zeros((3, 5, 5, 6), dtype=torch.float64),
                                    torch.zeros((3, 4, 5, 6), dtype=torch.float64),
                                    0.5, -0.5, 0.25)
    with pytest.raises(ValueError, match="groups"):
        fused.fused_schur_x_batched(v, v, torch.zeros((1, 7, 20), dtype=torch.float64),
                                    torch.zeros((1, 6, 20), dtype=torch.float64),
                                    0.5, -0.5, 0.25)
