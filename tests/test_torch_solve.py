"""The port's solver layers against neutfem_tpu at float64 on the CPU.

* schur_matvec: the port's fused path (plain direction recurrences) and its
  unfused composition against the JAX matvec, unfused and with the Pallas
  kernels in interpret mode (rel <= 1e-12);
* pcg on one equilibrated group system: identical iteration count, rel(x) <= 1e-10;
* power_iteration on a small scattering problem and the NeutFEM facade on the
  IAEA-3D benchmark: |dk| <= 1e-9 and identical outer counts.  Inner totals
  should be identical; a difference of at most 2 is allowed because the two
  packages sum their dot products in different orders, which can flip one CG
  stop test that sits on a tie.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.krylov import pcg as j_pcg
from neutfem_tpu.ops.apply import schur_matvec as j_schur_matvec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch.krylov import pcg
from neutfem_tpu_torch.ops.apply import phi_to_internal, schur_matvec
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, ctx_group, power_iteration

torch.set_num_threads(1)

F64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _problem(shape, seed=0, scatter=True):
    """(JAX fes, JAX ctx, port ctx) of one random 2-group problem, float64."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (nx, ny, nz)])
    fes = j_fespace.make_fespace(mesh, 0, 0)
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    if scatter:
        xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(3):
        bcs.set(j_mesh.boundary_attribute(3, ax, False), BCKind.MIRROR)
        bcs.set(j_mesh.boundary_attribute(3, ax, True), BCKind.DIRICHLET)
    jctx = j_build_context(fes, ng, xs, bcs, a_mode="exact", dtype=jnp.float64)
    tctx = ctx_from_numpy({k: np.asarray(v) for k, v in jctx.items()}, "cpu", F64)
    return fes, jctx, tctx, rng


@pytest.fixture(scope="module")
def kernel_problem():
    return _problem((8, 64, 64))  # the JAX fused kernels engage at this shape


@pytest.fixture(scope="module")
def small_problem():
    return _problem((6, 7, 9), seed=3)


@pytest.mark.parametrize("port,jax_mode", [("fused", "interpret"), ("fused", "unfused"),
                                           ("unfused", "unfused")])
def test_schur_matvec_matches_jax(kernel_problem, small_problem, monkeypatch, port, jax_mode):
    fes, jctx, tctx, rng = kernel_problem if jax_mode == "interpret" else small_problem
    v = rng.standard_normal((1, *fes.mesh.shape))
    if jax_mode == "interpret":
        monkeypatch.setenv("NEUTFEM_PALLAS_INTERPRET", "1")
    want = jax_jitted.schur_matvec(fes, j_ctx_group(jctx, 1), jnp.asarray(v), "exact",
                                   fused=jax_mode == "interpret")
    got = schur_matvec(fes, ctx_group(tctx, 1), torch.tensor(v), "exact",
                       fused=port == "fused")
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_schur_matvec_all_groups_unfused_matches_jax(small_problem):
    fes, jctx, tctx, rng = small_problem
    v = rng.standard_normal((2, 1, *fes.mesh.shape))
    want = jax_jitted.schur_matvec(fes, jctx, jnp.asarray(v), "exact", fused=False)
    got = schur_matvec(fes, tctx, torch.tensor(v), "exact", fused=False)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_layout_converters_and_weighted_mass_match_jax(small_problem):
    from neutfem_tpu.ops.apply import J_to_public as j_J_to_public
    from neutfem_tpu.ops.apply import phi_to_internal as j_phi_to_internal
    from neutfem_tpu.ops.apply import weighted_mass as j_weighted_mass
    from neutfem_tpu_torch.ops.apply import J_to_public, weighted_mass

    fes, jctx, tctx, rng = small_problem
    phi = rng.standard_normal((2, *fes.mesh.shape, 1))
    jphi, tphi = j_phi_to_internal(jnp.asarray(phi)), phi_to_internal(torch.tensor(phi))
    assert np.array_equal(tphi.numpy(), np.asarray(jphi))
    want = j_weighted_mass(fes, jctx["nsf"], jctx["detJ"], jctx["w_mode_col"], jphi)
    got = weighted_mass(fes, tctx["nsf"], tctx["detJ"], tctx["w_mode_col"], tphi)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-15
    face = rng.standard_normal((2, 1, *fes.dirs[0].face_shape))
    jJ = j_J_to_public({"d0": {"face": jnp.asarray(face)}})
    tJ = J_to_public({"d0": {"face": torch.tensor(face)}})
    assert np.array_equal(tJ["d0"]["face"].numpy(), np.asarray(jJ["d0"]["face"]))


def test_pcg_matches_jax_on_equilibrated_group_system():
    fes, jctx, tctx, rng = _problem((6, 7, 9), seed=4)
    rhs = rng.standard_normal((1, *fes.mesh.shape))
    x0 = rng.standard_normal((1, *fes.mesh.shape))
    jg, tg = j_ctx_group(jctx, 0), ctx_group(tctx, 0)
    jsdi, tsdi = jnp.sqrt(jg["precond_inv"]), torch.sqrt(tg["precond_inv"])
    jres = j_pcg(lambda y: jsdi * j_schur_matvec(fes, jg, y * jsdi, "exact"),
                 jnp.asarray(rhs) * jsdi, jnp.asarray(x0) / jsdi, tol=1e-9, maxiter=500)
    tres = pcg(lambda y: tsdi * schur_matvec(fes, tg, y * tsdi, "exact"),
               torch.tensor(rhs) * tsdi, torch.tensor(x0) / tsdi, tol=1e-9, maxiter=500)
    assert tres.iterations == int(jres.iterations) > 5
    assert _rel(tres.x.numpy(), np.asarray(jres.x)) <= 1e-10
    assert abs(float(tres.residual) - float(jres.residual)) <= 1e-12


@pytest.mark.parametrize("inner_eta,accel", [(0.0, "chebyshev"), (0.03, "none")])
def test_power_iteration_matches_jax(inner_eta, accel):
    fes, jctx, tctx, _ = _problem((5, 6, 7), seed=1)
    kw = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-7, inner_eta=inner_eta,
              accel=accel, max_outer=150)
    phi0 = np.ones((2, *fes.mesh.shape, 1))
    jres = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx, jnp.asarray(phi0), 1.0)
    tres = power_iteration(fes, 2, SolveOptions(**kw), tctx, torch.tensor(phi0), 1.0)
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["outer_iterations"] == int(jres["outer_iterations"]) < 150
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-7
    for key, entry in tres["J"].items():  # compute_current: one Thomas solve per direction
        assert _rel(entry["face"].numpy(), np.asarray(jres["J"][key]["face"])) <= 1e-7


def test_facade_iaea3d_matches_jax():
    """IAEA-3D 1x1 (19^3 cells) through both NeutFEM facades at the benchmark
    tests' tolerances; k is also held to this repo's pin (tests/test_benchmarks.py)."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS["iaea3d"]
    jrun = JRun(spec, mesh_n=1, mesh_nz=1)
    jrun.solve(tol=tol)
    trun = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu", dtype=F64)
    trun.solve(tol=tol)
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert trun.keff == pytest.approx(1.027866, abs=5e-5)
    assert trun.solver._last_outers == jrun.solver._last_outers
    assert abs(trun.solver._last_inners - jrun.solver._last_inners) <= 2
    hist_t, hist_j = trun.solver.get_iteration_history(), jrun.solver.get_iteration_history()
    assert hist_t.shape == hist_j.shape
    assert _rel(trun.solver._phi.numpy(), np.asarray(jrun.solver._phi)) <= 1e-7


def test_facade_iaea2d_matches_jax():
    """A 2D core (y and x fused directions on a (1, ny, nx) grid, fake z axis)."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS["iaea2d"]
    jrun = JRun(spec, mesh_n=2)
    jrun.solve(tol=tol)
    trun = BenchmarkRun(spec, mesh_n=2, device="cpu", dtype=F64)
    trun.solve(tol=tol)
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert trun.solver._last_outers == jrun.solver._last_outers
    assert abs(trun.solver._last_inners - jrun.solver._last_inners) <= 2
