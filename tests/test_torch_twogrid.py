"""The port's two-grid coarse level and the 2D cores against neutfem_tpu on the CPU.

* coarse factors, the dense-cap coarsening and the auto rule on the meshes of
  the five benchmark cores at several refinements (KOEBERG 32x32 and ZION
  48x48 built as meshes only), and the volume-averaged coarse XS;
* dense_schur_group (rel <= 1e-12), the attached coarse level key by key and
  its dense inverse schur_minv (rel <= 1e-10; bfloat16 at float32), the
  Chebyshev form's schur_lmax (rel <= 1e-10) and twogrid_correction on a
  random residual, dense and Chebyshev (rel <= 1e-12);
* group_solve in "twogrid" (identical CG iteration count, rel(x) <= 1e-10),
  power_iteration with a coarse level attached (|dk| <= 1e-9, identical
  outers, inners within 2: the two packages sum their dot products in
  different orders, which can flip one CG stop test that sits on a tie), a
  JAX context with "tg" carried over by ctx_from_numpy, and the two NeutFEM
  facades on IAEA-2D and KOEBERG 2x2 under NEUTFEM_PRECOND=twogrid and auto;
* the port runner's vectorized ZION baffle against the JAX runner's per-cell
  search (the per-cell cross sections, exactly).
All at float64 unless stated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import coarse as j_coarse
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu import twogrid as j_twogrid
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch import coarse, twogrid
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy
from neutfem_tpu_torch.ops import direct
from neutfem_tpu_torch.ops.direct import dense_schur_group
from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_solve, power_iteration

torch.set_num_threads(1)

F64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale > 0 else 1.0))


def _core_breaks(name, n, nz=1):
    """The breakpoints BenchmarkRun builds for a benchmark core (mesh only)."""
    from benchmarks.data import BENCHMARKS

    spec = BENCHMARKS[name]
    rows = spec.layout if spec.dim == 2 else spec.layout3d[0]
    h = spec.pitch / n
    xb = np.linspace(0.0, len(rows[0]) * n * h, len(rows[0]) * n + 1)
    yb = np.linspace(0.0, len(rows) * n * h, len(rows) * n + 1)
    if spec.dim == 2:
        return xb, yb, None
    planes = len(spec.layout3d) * nz
    return xb, yb, np.linspace(0.0, planes * spec.pitch_z / nz, planes + 1)


@pytest.mark.parametrize("name,n,nz", [
    ("iaea2d", 1, 1), ("iaea2d", 2, 1), ("iaea2d", 16, 1), ("iaea2d", 32, 1),
    ("biblis2d", 2, 1), ("biblis2d", 8, 1), ("biblis2d", 32, 1),
    ("koeberg2d", 2, 1), ("koeberg2d", 16, 1), ("koeberg2d", 32, 1),
    ("zion2d", 2, 1), ("zion2d", 8, 1), ("zion2d", 48, 1), ("zion2d", 64, 1), ("zion2d", 68, 1),
    ("iaea3d", 1, 1), ("iaea3d", 6, 4), ("iaea3d", 8, 8),
])
def test_coarse_factors_and_auto_rule_match_jax(name, n, nz):
    breaks = _core_breaks(name, n, nz)
    jm = j_mesh.CartesianMesh.from_breaks(*breaks)
    tm = t_mesh.CartesianMesh.from_breaks(*breaks)
    for mf in (2, 3, 4, 8, 12):
        assert (coarse.default_coarse_factors(tm, mf)
                == j_coarse.default_coarse_factors(jm, mf))
    assert twogrid.default_tg_factors(tm) == j_twogrid.default_tg_factors(jm)
    for cap in (256, 4096, twogrid.DENSE_MAX_NC):
        assert twogrid.dense_tg_factors(tm, cap) == j_twogrid.dense_tg_factors(jm, cap)
    assert twogrid.auto_twogrid(tm) == j_twogrid.auto_twogrid(jm)
    assert (twogrid.AUTO_TG_MIN_CELLS, twogrid.DENSE_MAX_NC) == (
        j_twogrid.AUTO_TG_MIN_CELLS, j_twogrid.DENSE_MAX_NC)
    if (name, n) in (("koeberg2d", 32), ("zion2d", 48)):
        # the coarse levels the fine 2D rows run: 68x68 and 76x76
        assert twogrid.auto_twogrid(tm)
        assert twogrid.dense_tg_factors(tm, twogrid.DENSE_MAX_NC) == (
            {"koeberg2d": (8, 8, 1), "zion2d": (12, 12, 1)}[name])


@pytest.mark.parametrize("dim", [2, 3])
def test_coarsen_xs_matches_jax(dim):
    rng = np.random.default_rng(dim)
    shape = (4 if dim == 3 else 1, 6, 8)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
              for n in (shape[2], shape[1])] + (
        [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, shape[0]))])] if dim == 3
        else [None])
    xs = {k: rng.uniform(0.1, 2.0, (2, *shape)) for k in ("D", "SigR", "NSF", "Chi", "SRC")}
    xs["SigS"] = rng.uniform(0.0, 0.1, (2, 2, *shape))
    factors = (4, 3, 2)
    jcm, jcxs = j_coarse.coarsen_xs(j_mesh.CartesianMesh.from_breaks(*breaks), xs, factors)
    tcm, tcxs = coarse.coarsen_xs(t_mesh.CartesianMesh.from_breaks(*breaks), xs, factors)
    assert tcm.shape == jcm.shape
    for b in ("x_breaks", "y_breaks", "z_breaks"):
        assert np.array_equal(getattr(tcm, b), getattr(jcm, b))
    assert set(tcxs) == set(jcxs)
    for k in jcxs:
        assert _rel(tcxs[k], jcxs[k]) <= 1e-14, k


def _problem_2d(ny=12, nx=16, seed=0, ng=2, upscatter=False):
    """(JAX fes, port fes, xs, JAX bcs, port bcs, JAX ctx, port ctx) of one random
    2D problem with MIRROR low faces and vacuum high faces, float64."""
    rng = np.random.default_rng(seed)
    shape = (1, ny, nx)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (nx, ny)]
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)),
          "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    for g in range(1, ng):
        xs["SigS"][g, g - 1] = rng.uniform(0.01, 0.03, shape)
    if upscatter:
        xs["SigS"][0, ng - 1] = rng.uniform(0.001, 0.003, shape)
    jb, tb = JBCSpec(), BCSpec()
    for ax in range(2):
        for up in (False, True):
            kind = "DIRICHLET" if up else "MIRROR"
            jb.set(j_mesh.boundary_attribute(2, ax, up), JBCKind[kind])
            tb.set(t_mesh.boundary_attribute(2, ax, up), BCKind[kind])
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=F64)
    return jfes, tfes, xs, jb, tb, jctx, tctx


def _attach(prob, mode, factors=None):
    jfes, tfes, xs, jb, tb, jctx, tctx = prob
    ng = xs["D"].shape[0]
    j_twogrid.attach_twogrid(jfes, ng, xs, jb, jctx, factors=factors, dtype=jnp.float64,
                             mode=mode)
    twogrid.attach_twogrid(tfes, ng, xs, tb, tctx, factors=factors, mode=mode)
    assert "tg" in jctx and "tg" in tctx
    return jctx, tctx


@pytest.fixture(scope="module")
def dense_pair():
    prob = _problem_2d()
    return prob, _attach(prob, "dense")


@pytest.fixture(scope="module")
def cheby_pair():
    prob = _problem_2d(seed=1)
    return prob, _attach(prob, "cheby")


@pytest.mark.parametrize("dim", [2, 3])
def test_dense_schur_group_matches_jax(monkeypatch, dim):
    monkeypatch.setattr(direct, "COLUMN_CHUNK", 37)  # several chunks, the last one ragged
    if dim == 2:
        jfes, tfes, _, _, _, jctx, tctx = _problem_2d(ny=9, nx=11, seed=4)
    else:
        rng = np.random.default_rng(5)
        shape = (3, 4, 5)
        breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (5, 4, 3)]
        xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape))}
        for k in ("NSF", "Chi", "SRC"):
            xs[k] = np.zeros((2, *shape))
        xs["SigS"] = np.zeros((2, 2, *shape))
        jb, tb = JBCSpec(), BCSpec()
        for ax in range(3):
            for up in (False, True):
                jb.set(j_mesh.boundary_attribute(3, ax, up), JBCKind.DIRICHLET)
                tb.set(t_mesh.boundary_attribute(3, ax, up), BCKind.DIRICHLET)
        jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
        tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
        jctx = j_build_context(jfes, 2, xs, jb, a_mode="exact", dtype=jnp.float64)
        tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=F64)
    for g in range(2):
        want = jax_jitted.dense_schur_group(jfes, j_ctx_group(jctx, g), "exact")
        got = dense_schur_group(tfes, ctx_group(tctx, g), "exact")
        assert got.shape == (tfes.n_phi, tfes.n_phi)
        assert torch.equal(got, got.T)
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_attached_dense_level_matches_jax(dense_pair):
    (_, tfes, *_), (jctx, tctx) = dense_pair
    jtg, ttg = jctx["tg"], tctx["tg"]
    assert twogrid.tg_factors_of(tfes, ttg) == (2, 2, 1)  # the richest: 6x8 coarse cells
    assert set(ttg) <= set(jtg) and "schur_minv" in ttg and "schur_lmax" not in ttg
    assert ttg["schur_minv"].dtype == F64 and ttg["schur_minv"].shape == (2, 48, 48)
    assert _rel(ttg["schur_minv"].numpy(), np.asarray(jtg["schur_minv"])) <= 1e-10
    for k, v in ttg.items():
        if k != "schur_minv":
            assert _rel(v.numpy(), np.asarray(jtg[k])) <= 1e-12, k


def test_attached_cheby_level_matches_jax(cheby_pair):
    _, (jctx, tctx) = cheby_pair
    lmax = tctx["tg"]["schur_lmax"]
    assert lmax.shape == (2,) and "schur_minv" not in tctx["tg"]
    assert _rel(lmax.numpy(), np.asarray(jctx["tg"]["schur_lmax"])) <= 1e-10


def test_dense_level_falls_back_to_cheby_above_the_cap():
    prob = _problem_2d(ny=8, nx=8, seed=2)
    jfes, tfes, xs, jb, tb, jctx, tctx = prob
    # explicit factors are honored: 4x4 coarse cells, above a cap of 8
    j_twogrid.attach_twogrid(jfes, 2, xs, jb, jctx, factors=(2, 2, 1), dtype=jnp.float64,
                             dense_max=8)
    twogrid.attach_twogrid(tfes, 2, xs, tb, tctx, factors=(2, 2, 1), dense_max=8)
    assert "schur_lmax" in tctx["tg"] and "schur_lmax" in jctx["tg"]
    assert _rel(tctx["tg"]["schur_lmax"].numpy(), np.asarray(jctx["tg"]["schur_lmax"])) <= 1e-10


def test_dense_level_is_bfloat16_at_float32():
    jfes, tfes, xs, jb, tb, jctx, tctx = _problem_2d(seed=3)
    tctx32 = build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32)
    twogrid.attach_twogrid(tfes, 2, xs, tb, tctx32)
    minv = tctx32["tg"]["schur_minv"]
    assert minv.dtype == torch.bfloat16 and tctx32["tg"]["C"].dtype == torch.float32
    twogrid.attach_twogrid(tfes, 2, xs, tb, tctx)
    assert _rel(minv.float().numpy(), tctx["tg"]["schur_minv"].numpy()) <= 1e-2


@pytest.mark.parametrize("form", ["dense", "cheby"])
def test_twogrid_correction_matches_jax(dense_pair, cheby_pair, form):
    (jfes, tfes, *_), (jctx, tctx) = dense_pair if form == "dense" else cheby_pair
    r = np.random.default_rng(7).standard_normal((1, *tfes.mesh.shape))
    kw = dict(tg_degree=5, tg_kappa=20.0)
    for g in range(2):
        want = jax_jitted.twogrid_correction(jfes, j_ctx_group(jctx, g), JSolveOptions(**kw),
                                             jnp.asarray(r))
        got = twogrid.twogrid_correction(tfes, ctx_group(tctx, g), SolveOptions(**kw),
                                         torch.tensor(r))
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("form", ["dense", "cheby"])
def test_group_solve_twogrid_matches_jax(dense_pair, cheby_pair, form):
    (jfes, tfes, *_), (jctx, tctx) = dense_pair if form == "dense" else cheby_pair
    rng = np.random.default_rng(8)
    rhs, x0 = rng.standard_normal((2, 1, *tfes.mesh.shape))
    kw = dict(inner_precond="twogrid", inner_tol=1e-10, max_inner=500)
    jres = jax_jitted.group_solve(jfes, j_ctx_group(jctx, 1), JSolveOptions(**kw),
                                  jnp.asarray(rhs), jnp.asarray(x0))
    tres = group_solve(tfes, ctx_group(tctx, 1), SolveOptions(**kw), torch.tensor(rhs),
                       torch.tensor(x0))
    assert tres.iterations == int(jres.iterations) > 3
    assert _rel(tres.x.numpy(), np.asarray(jres.x)) <= 1e-10


@pytest.fixture(scope="module")
def three_group_pair():
    """A 3-group problem with upscatter and its dense coarse level attached in
    both packages, shared by the preconditioner modes below (the solves do
    not change the contexts)."""
    prob = _problem_2d(ny=16, nx=20, seed=9, ng=3, upscatter=True)
    return prob, _attach(prob, "dense")


@pytest.mark.parametrize("precond", ["twogrid", "auto"])
def test_power_iteration_with_coarse_level_matches_jax(three_group_pair, precond):
    prob, (jctx, tctx) = three_group_pair
    jfes, tfes = prob[:2]
    kw = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-7, inner_eta=0.03, max_outer=150,
              inner_precond=precond)
    phi0 = np.ones((3, *tfes.mesh.shape, 1))
    jres = jax_jitted.power_iteration(jfes, 3, JSolveOptions(**kw), jctx, jnp.asarray(phi0), 1.0)
    tres = power_iteration(tfes, 3, SolveOptions(**kw), tctx, torch.tensor(phi0), 1.0)
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["outer_iterations"] == int(jres["outer_iterations"]) < 150
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-7


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_ctx_from_numpy_carries_the_coarse_level(dtype):
    """A JAX context with "tg" goes through ctx_from_numpy (bfloat16 coarse
    inverse bit for bit at float32), and the port's solve on it agrees with
    the JAX solve."""
    prob = _problem_2d(seed=10)
    jfes, tfes, xs, jb, *_ = prob
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jctx = j_build_context(jfes, 2, xs, jb, a_mode="exact", dtype=jdt)
    j_twogrid.attach_twogrid(jfes, 2, xs, jb, jctx, dtype=jdt)
    carried = ctx_from_numpy(jctx, "cpu", dtype)
    minv, jminv = carried["tg"]["schur_minv"], np.asarray(jctx["tg"]["schur_minv"])
    if dtype == F64:
        assert minv.dtype == F64 and np.array_equal(minv.numpy(), jminv)
        rhs = np.random.default_rng(11).standard_normal((1, *tfes.mesh.shape))
        kw = dict(inner_precond="twogrid", inner_tol=1e-10)
        jres = jax_jitted.group_solve(jfes, j_ctx_group(jctx, 0), JSolveOptions(**kw),
                                      jnp.asarray(rhs), jnp.asarray(rhs))
        tres = group_solve(tfes, ctx_group(carried, 0), SolveOptions(**kw),
                           torch.tensor(rhs), torch.tensor(rhs))
        assert tres.iterations == int(jres.iterations)
        assert _rel(tres.x.numpy(), np.asarray(jres.x)) <= 1e-10
    else:
        assert jminv.dtype.name == "bfloat16" and minv.dtype == torch.bfloat16
        assert np.array_equal(minv.view(torch.int16).numpy(), jminv.view(np.int16))
        assert carried["tg"]["C"].dtype == torch.float32


@pytest.mark.parametrize("core,precond", [("iaea2d", "twogrid"), ("iaea2d", "auto"),
                                          ("koeberg2d", "twogrid"), ("koeberg2d", "auto")])
def test_facade_2d_core_matches_jax(monkeypatch, core, precond):
    """IAEA-2D and KOEBERG (4 groups, upscatter) 2x2 through both facades; the
    JAX facade attaches the coarse level at its first solve, the port's in
    BuildMatrices."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    monkeypatch.setenv("NEUTFEM_PRECOND", precond)
    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS[core]
    jrun = JRun(spec, mesh_n=2)
    jrun.solve(tol=tol)
    trun = BenchmarkRun(spec, mesh_n=2, device="cpu", dtype=F64)
    trun.solve(tol=tol)
    assert ("tg" in trun.solver._ctx) == ("tg" in jrun.solver._ctx("exact")) == (
        precond == "twogrid")
    assert trun.solver.preconditioner() == ("twogrid" if precond == "twogrid" else "jacobi")
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert trun.solver._last_outers == jrun.solver._last_outers
    assert abs(trun.solver._last_inners - jrun.solver._last_inners) <= 2


@pytest.mark.parametrize("mesh_n", [2, 4, 8])
def test_zion_baffle_matches_jax_runner(mesh_n):
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    spec = BENCHMARKS["zion2d"]
    js = JRun(spec, mesh_n=mesh_n).solver
    ts = BenchmarkRun(spec, mesh_n=mesh_n, device="cpu", dtype=F64).solver
    baffle_cells = 0
    for get in ("get_D", "get_SigR", "get_NSF", "get_Chi", "get_SigS"):
        want = np.asarray(getattr(js, get)())
        got = getattr(ts, get)()
        assert got.shape == want.shape and np.array_equal(got, want), get
    baffle_d = spec.baffle[0]["D"][0]
    baffle_cells = int(np.sum(ts.get_D()[0] == baffle_d))
    assert baffle_cells > 0


def test_main_2d_prints_the_jax_row():
    """bench.main_2d on the CPU at a tiny mesh: the JAX row's metric and detail
    keys plus the device, dtype, resolved preconditioner and the timed
    solve's CG counts (on the CPU one host read an iteration, one for a solve
    that needs none)."""
    from neutfem_tpu_torch import bench

    out = bench.main_2d("koeberg2d", 1, device="cpu", dtype=F64)
    assert out["metric"] == "koeberg2d_4group_seconds_per_outer_iteration"
    assert set(out["detail"]) == {"keff", "pcm", "n_cells", "n_groups", "outer_iterations",
                                  "inner_iterations", "solve_wall_s", "mesh", "device",
                                  "dtype", "preconditioner", "cg"}
    cg = out["detail"]["cg"]
    assert cg["iterations"] == out["detail"]["inner_iterations"]
    assert cg["iterations"] <= cg["host_reads"] <= cg["iterations"] + cg["solves"]
    assert cg["replays"] == cg["captures"] == 0
    assert out["detail"]["n_cells"] == 17 * 17 and out["detail"]["n_groups"] == 4
    assert out["detail"]["preconditioner"] == "jacobi" and out["detail"]["device"] == "cpu"
