"""The solver variants of neutfem_tpu_torch against neutfem_tpu at float64 on the CPU.

* the adjoint (``NeutFEM.SolveAdjoint``), free-running and at the direct k,
  with the biorthogonal normalization, on IAEA-3D 1x1 and KOEBERG 2x2 (4
  groups with upscatter: the reverse group sweep matters): |dk| <= 1e-9,
  identical outer counts, inner totals within 2, the normalized adjoint flux
  to rel 1e-7;
* the coarse-grid initialization (``SolveKeff(use_coarse_init=True)``) and
  ``SolveCoarse`` on IAEA-2D 2x2: the same tolerances;
* the explicit-Schur direct solve (DIRECT_LLT) under the dense gate on IAEA-2D
  1x1, and the gate's warning and CG above it;
* CMFD (mode "fixed"): one correction inside the power iteration to 1e-9 in
  k.  A whole CMFD solve is not reproducible to rounding: its low-order CG
  runs on an indefinite operator (the JAX package's ``cmfd_correction``
  docstring) and stops at its 100-iteration cap, so rounding differences grow
  (measured on IAEA-2D 2x2: the two packages' k differ by 9e-10 after 5
  outers and 1e-6 after 10, and a 1e-14 change of the port's start flux moves
  its outer count from 176 to 177).  The whole solve is held to the JAX k
  within 2e-6 (tol_keff 1e-6) and to the Gauss-Seidel k within 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from benchmarks.data import BENCHMARKS
from benchmarks.runner import BenchmarkRun as JRun
from neutfem import LinearSolverType as JLinearSolverType
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu_torch.bench import BenchmarkRun
from neutfem_tpu_torch.compat import LinearSolverType
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.ops.direct import attach_dense_schur, direct_solve
from neutfem_tpu_torch.power import SolveOptions, ctx_group, power_iteration

torch.set_num_threads(1)

F64 = torch.float64
TOL = (1e-6, 1e-5, 1e-5, 300, 1000)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _runs(core, n, nz=1):
    spec = BENCHMARKS[core]
    jrun = JRun(spec, mesh_n=n, mesh_nz=nz)
    trun = BenchmarkRun(spec, mesh_n=n, mesh_nz=nz, device="cpu", dtype=F64)
    for run in (jrun, trun):
        run.solver.set_tol(*TOL)
    return jrun.solver, trun.solver


def _adjoints(core, n):
    """Both facades: a direct solve, the adjoint at its k, then a free-running
    adjoint from a cold adjoint flux (bench.py's adjoint row)."""
    out = {}
    for pkg, s in zip(("jax", "torch"), _runs(core, n)):
        s.SolveKeff()
        rows = {}
        for mode in ("fixed", "free"):
            s._phi_adj = None
            k = s.SolveAdjoint(use_direct_keff=mode == "fixed")
            hist = s.get_iteration_history()
            rows[mode] = (k, len(hist), float(np.sum(hist[:, 3])), np.asarray(s._phi_adj),
                          s.get_flux_adj().copy(), s.GetLastKeffAdjoint())
        out[pkg] = rows
    return out


@pytest.fixture(scope="module", params=[("iaea3d", 1), ("koeberg2d", 2)], ids=lambda p: p[0])
def adjoints(request):
    return _adjoints(*request.param)


@pytest.mark.parametrize("mode", ["fixed", "free"])
def test_adjoint_matches_jax(adjoints, mode):
    kj, oj, ij, pj, fj, lj = adjoints["jax"][mode]
    kt, ot, it, pt, ft, lt = adjoints["torch"][mode]
    assert abs(kt - kj) <= 1e-9
    assert lt == kt and abs(lj - kj) <= 1e-15
    assert ot == oj
    assert abs(it - ij) <= 2
    assert _rel(pt, pj) <= 1e-7  # biorthogonally normalized adjoint flux
    assert _rel(ft, fj) <= 1e-7  # get_flux_adj: its P_0 view


def test_adjoint_outers_and_normalization():
    """The adjoint's own pieces against the JAX functions: the free-running k
    equals the direct k (same spectrum), and <phi, phi_adj>_M = 1 after the
    normalization."""
    from neutfem_tpu_torch.power import biorthogonal_inner

    _, s = _runs("iaea2d", 1)
    k = s.SolveKeff()
    k_adj = s.SolveAdjoint(use_direct_keff=False)
    assert abs(k_adj - k) <= 2e-6
    assert float(biorthogonal_inner(s._ctx, s._phi, s._phi_adj)) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("how", ["solve_keff", "solve_coarse"])
def test_coarse_init_matches_jax(how):
    j, t = _runs("iaea2d", 2)
    if how == "solve_keff":
        kj = j.SolveKeff(use_coarse_init=True, coarse_factors=(2, 2))
        kt = t.SolveKeff(use_coarse_init=True, coarse_factors=(2, 2))
        assert abs(kt - kj) <= 1e-9
        assert t._last_outers == j._last_outers
        assert abs(t._last_inners - j._last_inners) <= 2
    else:
        kcj, phij = j.SolveCoarse((2, 2))
        kct, phit = t.SolveCoarse((2, 2))
        assert abs(kct - kcj) <= 1e-9
        assert phit.shape == phij.shape
        assert _rel(phit, phij) <= 1e-7
        assert t._keff == kct  # the next SolveKeff starts from the coarse solution


def test_direct_solver_matches_jax():
    j, t = _runs("iaea2d", 1)
    assert t._fes.n_phi <= 4096
    j.set_linear_solver(JLinearSolverType.DIRECT_LLT)
    t.set_linear_solver(LinearSolverType.DIRECT_LLT)
    kj, kt = j.SolveKeff(), t.SolveKeff()
    assert "schur_chol" in t._ctx and tuple(t._ctx["schur_chol"].shape) == (2, 361, 361)
    assert abs(kt - kj) <= 1e-9
    assert t._last_outers == j._last_outers
    assert t._last_inners == j._last_inners == 2 * t._last_outers  # one "iteration" per solve
    assert t.GetSolverName() == j.GetSolverName() == "SimplicialLLT"


def test_direct_factors_and_batched_solve_match_jax():
    """attach_dense_schur's factors against the JAX ones (carried across by
    ctx_from_numpy), and direct_solve on one group and on the Jacobi sweep's
    batch."""
    from neutfem_tpu.ops.direct import attach_dense_schur as j_attach
    from neutfem_tpu.ops.direct import direct_solve as j_direct_solve
    from neutfem_tpu.power import ctx_group as j_ctx_group

    j, t = _runs("iaea2d", 1)
    jctx = j._ctx("exact")
    j_attach(j._fes, jctx, "exact")
    attach_dense_schur(t._fes, t._ctx)
    carried = ctx_from_numpy({k: np.asarray(jctx[k]) for k in ("schur_chol", "schur_sdi")},
                             "cpu", F64)
    for k in ("schur_chol", "schur_sdi"):
        assert _rel(t._ctx[k].numpy(), carried[k].numpy()) <= 1e-12, k
    rhs = np.random.default_rng(0).standard_normal((2, 1, *t._fes.mesh.shape))
    want = j_direct_solve(jctx, jnp.asarray(rhs))
    assert _rel(direct_solve(t._ctx, torch.tensor(rhs)).numpy(), np.asarray(want)) <= 1e-10
    want1 = j_direct_solve(j_ctx_group(jctx, 1), jnp.asarray(rhs[1]))
    got1 = direct_solve(ctx_group(t._ctx, 1), torch.tensor(rhs[1]))
    assert _rel(got1.numpy(), np.asarray(want1)) <= 1e-10


def test_direct_gate_warns_and_runs_cg(monkeypatch):
    monkeypatch.setenv("NEUTFEM_DIRECT_MAX_NPHI", "100")
    _, t = _runs("iaea2d", 1)
    t.set_linear_solver(LinearSolverType.DIRECT_LDLT)
    with pytest.warns(RuntimeWarning, match="gated to n_phi <= 100"):
        k = t.SolveKeff()
    assert "schur_chol" not in t._ctx
    assert t._last_inners > 2 * t._last_outers  # CG iterations, not one per solve
    _, c = _runs("iaea2d", 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert abs(c.SolveKeff() - k) <= 1e-12  # the CG solve itself


def test_cmfd_correction_step_matches_jax():
    """Three outers: two plain ones, then one CMFD correction (from iteration
    2) before the k update."""
    j, t = _runs("iaea2d", 2)
    fes = j._fes
    shape = (2, *fes.mesh.shape, 1)
    kw = dict(tol_keff=1e-6, tol_flux=1e-5, inner_tol=1e-5, inner_eta=0.03, use_cmfd=True,
              max_outer=3)
    jres = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), j._ctx("exact"),
                                      jnp.ones(shape), 1.0)
    tres = power_iteration(t._fes, 2, SolveOptions(**kw), t._ctx,
                           torch.ones(shape, dtype=F64), 1.0)
    nocmfd = power_iteration(t._fes, 2, SolveOptions(**{**kw, "use_cmfd": False}), t._ctx,
                             torch.ones(shape, dtype=F64), 1.0)
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["inner_iterations"] == int(jres["inner_iterations"])
    # the flux after one correction: the low-order CG (indefinite, at its
    # iteration cap) lifts rounding differences to ~3e-8 (measured)
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-6
    assert _rel(tres["phi"].numpy(), nocmfd["phi"].numpy()) > 1e-4  # the correction acted


def test_cmfd_solve_matches_jax():
    j, t = _runs("iaea2d", 2)
    kj = j.SolveKeff(use_cmfd=True)
    kt = t.SolveKeff(use_cmfd=True)
    assert abs(kt - kj) <= 2e-6
    assert abs(t._last_outers - j._last_outers) <= 0.1 * j._last_outers
    _, g = _runs("iaea2d", 2)
    assert abs(kt - g.SolveKeff()) <= 1e-5
