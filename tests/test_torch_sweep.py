"""The Jacobi group sweep of neutfem_tpu_torch against neutfem_tpu at small sizes.

* K5 (and K1's group batch): the port's batched fused-direction wrappers
  (ops/fused.py, their plain versions on the CPU) against the JAX
  ``fused_schur_dir`` on a (2, 1, nz, ny, nx) flux with per-group operands,
  run in interpret mode (``_fused_y`` / ``_fused_x`` / ``_fused_z``), rel
  <= 1e-12 at float64 and <= 1e-5 at float32;
* ``schur_matvec`` on an un-sliced context (the sweep's batched CG): RT0 goes
  through the batched wrappers, k >= 1 through the unfused condensed chain;
* ``power_iteration(sweep="jacobi")`` against the JAX package at float64 on
  IAEA-3D 1x1 RT0-P0 and RT1-P1 (the batched block preconditioner) and
  IAEA-2D 2x2 with the two-grid level (the batched dense coarse apply, and the
  Chebyshev form whose coarse matvec runs the batched wrappers): |dk| <= 1e-9,
  identical outer counts, inner totals within 2.  The unaccelerated sweep
  needs hundreds of outers there; over so many outers the adaptive inner
  tolerance amplifies the two packages' rounding differences (measured: dk
  5e-12 after 200 outers, 3e-9 after 462 on IAEA-3D 1x1, against 1e-14 with
  a fixed inner tolerance), so these runs stop at a fixed outer count, and a
  small random problem checks a converged sweep.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.ops.pallas_fused import fused_fits, fused_schur_dir
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu_torch import tracing
from neutfem_tpu_torch.ops import fused
from neutfem_tpu_torch.ops.apply import schur_matvec
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, power_iteration

torch.set_num_threads(1)

F64 = torch.float64
TOL = {"f64": 1e-12, "f32": 1e-5}
DT = {"f64": (jnp.float64, torch.float64, np.float64),
      "f32": (jnp.float32, torch.float32, np.float32)}
SHAPE = (8, 64, 64)  # (nz, ny, nx): the JAX kernels engage on (2, 1, *SHAPE)


def _rel(got, want, base=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    base = np.zeros_like(want) if base is None else np.asarray(base, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


def _problem(shape, prec="f64", seed=0, k=0):
    """(JAX fes, JAX ctx, port ctx) of one random 2-group problem with a MIRROR
    face on every direction."""
    jdt, tdt, _ = DT[prec]
    rng = np.random.default_rng(seed)
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in shape[::-1]])
    fes = j_fespace.make_fespace(mesh, k, k)
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(3):
        bcs.set(j_mesh.boundary_attribute(3, ax, False), BCKind.MIRROR)
        bcs.set(j_mesh.boundary_attribute(3, ax, True), BCKind.DIRICHLET)
    jctx = j_build_context(fes, ng, xs, bcs, a_mode="exact", dtype=jdt)
    tctx = ctx_from_numpy({k_: np.asarray(v) for k_, v in jctx.items()}, "cpu", tdt)
    return fes, jctx, tctx, rng


@pytest.fixture(scope="module", params=["f64", "f32"])
def kernel_problem(request):
    return request.param, _problem(SHAPE, request.param)


@pytest.mark.parametrize("direction", ["z", "y", "x"])
def test_batched_direction_matches_jax_interpret(kernel_problem, direction):
    prec, (fes, jctx, tctx, rng) = kernel_problem
    _, tdt, ndt = DT[prec]
    d = {"x": 0, "y": 1, "z": 2}[direction]
    di = [x for x in fes.dirs if x.d == d][0]
    key = f"d{d}"
    bx0, bx1, si = float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0])
    shape = (2, 1, *SHAPE)
    v = rng.standard_normal(shape).astype(ndt)
    acc = rng.standard_normal(shape).astype(ndt)
    axis = di.axis - 3
    assert fused_fits(shape, v.dtype, axis, interpret=True)
    want = fused_schur_dir(jnp.asarray(acc), jnp.asarray(v),
                           jnp.expand_dims(jctx[f"tri_dinvm_{key}"], -4),
                           jnp.expand_dims(jctx[f"tri_l_{key}"], -4), axis, bx0, bx1, si,
                           interpret=True)
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    tag = {"z": "", "y": "yT_", "x": "xT_"}[direction]
    wrapper = {"z": fused.fused_schur_z_batched, "y": fused.fused_schur_y_batched,
               "x": fused.fused_schur_x_batched}[direction]
    acc_t = torch.tensor(acc, dtype=tdt)
    got = wrapper(acc_t, torch.tensor(v, dtype=tdt), tctx[f"tri_{tag}dinvm_{key}"],
                  tctx[f"tri_{tag}l_{key}"], bx0, bx1, si)
    assert got is acc_t  # updated in place, like the aliased TPU kernel
    assert _rel(got.numpy(), np.asarray(want), acc) <= TOL[prec]


@pytest.mark.parametrize("k", [0, 1])
def test_batched_schur_matvec_matches_jax(k):
    """The sweep's matvec on every group at once: RT0 through the batched
    wrappers, RT1-P1 through the unfused condensed chain."""
    fes, jctx, tctx, rng = _problem((5, 6, 7), seed=5, k=k)
    v = rng.standard_normal((2, fes.P, *fes.mesh.shape))
    want = jax_jitted.schur_matvec(fes, jctx, jnp.asarray(v), "exact")
    with tracing.collect() as c:
        got = schur_matvec(fes, tctx, torch.tensor(v), "exact")
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12
    # the CPU runs the plain versions: no launch
    assert not [k for k in c.record["counters"] if k.startswith("fused.")]


def _jacobi_pair(core, n, nz, order=0):
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    spec = BENCHMARKS[core]
    jrun = JRun(spec, mesh_n=n, mesh_nz=nz, rt_order=order)
    trun = BenchmarkRun(spec, mesh_n=n, mesh_nz=nz, device="cpu", dtype=F64, rt_order=order)
    return spec.ng, jrun.solver._fes, jrun.solver._ctx("exact"), trun.solver


def _compare_sweeps(fes, ng, jctx, tctx, **kw):
    shape = (ng, *fes.mesh.shape, fes.P)
    jres = jax_jitted.power_iteration(fes, ng, JSolveOptions(sweep="jacobi", **kw), jctx,
                                      jnp.ones(shape), 1.0)
    tres = power_iteration(fes, ng, SolveOptions(sweep="jacobi", **kw), tctx,
                           torch.ones(shape, dtype=F64), 1.0)
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["outer_iterations"] == int(jres["outer_iterations"])
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-6
    return tres


#: the benchmark facade's settings (tol_flux 1e-5, adaptive inner tolerance)
SWEEP_KW = dict(tol_keff=1e-6, tol_flux=1e-5, inner_tol=1e-5, inner_eta=0.03)


@pytest.mark.parametrize("order,max_outer", [(0, 80), (1, 8)])
def test_jacobi_sweep_iaea3d_matches_jax(order, max_outer):
    ng, fes, jctx, solver = _jacobi_pair("iaea3d", 1, 1, order)
    _compare_sweeps(fes, ng, jctx, solver._ctx, max_outer=max_outer, **SWEEP_KW)


@pytest.mark.parametrize("tg_mode", ["dense", "cheby"])
def test_jacobi_sweep_twogrid_matches_jax(monkeypatch, tg_mode):
    monkeypatch.setenv("NEUTFEM_PRECOND", "twogrid")
    monkeypatch.setenv("NEUTFEM_TG_MODE", tg_mode)
    ng, fes, jctx, solver = _jacobi_pair("iaea2d", 2, 1)
    assert "tg" in jctx and "tg" in solver._ctx
    assert solver.preconditioner() == "twogrid"
    _compare_sweeps(fes, ng, jctx, solver._ctx, max_outer=30, **SWEEP_KW)


def test_jacobi_sweep_converges_like_jax():
    fes, jctx, tctx, _ = _problem((5, 6, 7), seed=1)
    tres = _compare_sweeps(fes, 2, jctx, tctx, tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-7,
                           max_outer=300)
    assert tres["outer_iterations"] < 300
    # the same fixed point as the Gauss-Seidel sweep
    gs = power_iteration(fes, 2, SolveOptions(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-7),
                         tctx, torch.ones((2, *fes.mesh.shape, 1), dtype=F64), 1.0)
    assert abs(float(gs["keff"]) - float(tres["keff"])) <= 1e-6
