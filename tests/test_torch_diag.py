"""The diagonal and lumped A-solves in the port against neutfem_tpu, at
float64 on the CPU.

``a_mode="diag"`` takes A^-1 ~ 1/diag(A) inside the Schur matvec (the
reference's RT0-P0 "diagonal Schur", behind its published eigenvalues),
``"lumped"`` the row-sum lumped A (mesh-centred finite differences); both at
RT0 only, with no Thomas factors and no kernel (the JAX package runs no
Pallas kernel there either).  Held here: the contexts (rel <= 1e-12);
``power_iteration`` under both on IAEA-3D 1x1 (|dk| <= 1e-9, the same outers,
inners within 2); the elementwise bug-compat solve against the dense
reference scheme (``tests/test_power.py``'s); ``SolveKeff(
use_diagonal_solver=True)``, ``build_diagonal_cache`` and DIRECT_LLT under the
diagonal solver against the JAX facade; ``bench.main_variants`` on the CPU.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import SolveOptions, power_iteration

torch.set_num_threads(1)

F64 = torch.float64


@pytest.mark.parametrize("a_mode", ["diag", "lumped"])
def test_context_matches_jax(a_mode):
    """Every key of the JAX context (1/diag(A) as tri_dinv, no tri_l, the
    diag-A estimate as precond_inv) on a 2D problem with MIRROR and vacuum
    faces, and the refusal above RT0."""
    from test_power import build_2d_problem

    mesh, fes, ng, xs, bcs = build_2d_problem()
    jctx = j_build_context(fes, ng, xs, bcs, a_mode=a_mode, dtype=jnp.float64)
    tctx = build_context(fes, ng, xs, bcs, "cpu", F64, a_mode=a_mode)
    assert set(tctx) == set(jctx) and not any(k.startswith("tri_l_") for k in tctx)
    for key, v in jctx.items():
        want = np.asarray(v)
        assert np.max(np.abs(tctx[key].numpy() - want)) <= (
            1e-12 * max(np.max(np.abs(want)), 1e-300)), key
    _, fes1, ng, xs, bcs = build_2d_problem(k=1, m=1)
    with pytest.raises(ValueError):
        build_context(fes1, ng, xs, bcs, "cpu", F64, a_mode=a_mode)


@pytest.mark.parametrize("a_mode", ["diag", "lumped"])
def test_power_iteration_matches_jax(a_mode):
    """power_iteration on IAEA-3D 1x1 (19^3 cells) under each A-solve."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu.power import SolveOptions as JSolveOptions

    j = JRun(BENCHMARKS["iaea3d"], mesh_n=1, mesh_nz=1).solver
    kw = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=200, a_mode=a_mode)
    jctx = j._ctx(a_mode)
    want = jax_jitted.power_iteration(j._fes, 2, JSolveOptions(**kw), jctx, j._flat_phi(), 1.0)
    tctx = {k: torch.tensor(np.asarray(v)) for k, v in jctx.items()}
    got = power_iteration(j._fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, 19, 19, 19, 1), dtype=F64), 1.0)
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= 2


def test_diag_elementwise_matches_dense_reference():
    """diag_elementwise: the group solve keeps only S_ee = C_ee + sum_f
    B_ef^2 / A_ff (NeutFEM.cpp:459-473, 607-634), solved elementwise; the
    eigenvalue of that dense scheme, and 0 inner iterations."""
    from oracle import DenseOracle
    from test_power import build_2d_problem

    mesh, fes, ng, xs, bcs = build_2d_problem()
    ctx = build_context(fes, ng, xs, bcs, "cpu", F64, a_mode="diag")
    oracle = DenseOracle(fes, ng, xs, bcs)
    n = oracle.n_phi
    detJ = oracle.mesh.det_jac()
    H = np.zeros((ng * n, ng * n))
    F = np.zeros((ng * n, ng * n))
    for g in range(ng):
        S = oracle.C[g] + oracle.B @ np.diag(1.0 / np.diag(oracle.A[g])) @ oracle.B.T
        H[g * n:(g + 1) * n, g * n:(g + 1) * n] = np.diag(np.diag(S))
        chi_g = np.repeat(np.asarray(xs["Chi"][g]).reshape(-1), fes.P)
        for gp in range(ng):
            w = (xs["SigS"][g, gp][..., None] * detJ[..., None] * fes.w_mode).reshape(-1)
            if gp != g:
                H[g * n:(g + 1) * n, gp * n:(gp + 1) * n] -= np.diag(w)
            wf = (xs["NSF"][gp][..., None] * detJ[..., None] * fes.w_mode).reshape(-1)
            F[g * n:(g + 1) * n, gp * n:(gp + 1) * n] = chi_g[:, None] * np.diag(wf)
    k_ref = float(np.max(scipy.linalg.eigvals(np.linalg.solve(H, F)).real))
    res = power_iteration(fes, ng, SolveOptions(tol_keff=1e-11, tol_flux=1e-9, a_mode="diag",
                                                diag_elementwise=True),
                          ctx, torch.ones((ng, *mesh.shape, fes.P), dtype=F64), 1.0)
    assert abs(float(res["keff"]) - k_ref) < 5e-9
    assert res["inner_iterations"] == 0


def _facades(solver_type=None):
    """The JAX and the port facade on a 2-group 2D core (6x5 cells, vacuum
    and MIRROR faces), built."""
    from neutfem import BCType as JBCType
    from neutfem import NeutFEM as JNeutFEM
    from neutfem import VerbosityLevel as JVerbosity
    from neutfem_tpu_torch.compat import BCType, BoundaryID, NeutFEM, VerbosityLevel

    rng = np.random.default_rng(3)
    sigr = rng.uniform(0.025, 0.1, (2, 5, 6))
    out = []
    for cls, bct, verb, kw in ((JNeutFEM, JBCType, JVerbosity, {}),
                               (NeutFEM, BCType, VerbosityLevel,
                                {"device": "cpu", "dtype": F64})):
        s = cls(0, 2, np.linspace(0, 10.2, 7), np.linspace(0, 10.5, 6), np.array([0.0]), **kw)
        s.set_verbosity(verb.SILENT)
        for bid in (BoundaryID.RIGHT_2D, BoundaryID.TOP_2D):
            s.set_bc(int(bid), bct.DIRICHLET)
        for bid in (BoundaryID.LEFT_2D, BoundaryID.BOTTOM_2D):
            s.set_bc(int(bid), bct.MIRROR)
        s.get_D()[0], s.get_D()[1] = 1.4, 0.4
        s.get_SigR()[:] = sigr
        s.get_NSF()[1] = 0.135
        s.get_SigS()[1, 0] = 0.02
        s.set_tol(1e-9, 1e-8, 1e-8, 300, 1000)
        if solver_type is not None:
            s.set_linear_solver(int(solver_type))
        s.BuildMatrices()
        out.append(s)
    return out


def test_facade_diagonal_solver_matches_jax():
    """SolveKeff(use_diagonal_solver=True) after build_diagonal_cache, both
    facades; the port keeps one context per A-solve; diag_elementwise warns,
    and without the diagonal solver raises ValueError."""
    j, t = _facades()
    j.build_diagonal_cache()
    t.build_diagonal_cache()
    assert "diag" in t._ctxs and "tri_l_d0" not in t._ctxs["diag"]
    kj = j.SolveKeff(use_diagonal_solver=True)
    kt = t.SolveKeff(use_diagonal_solver=True)
    assert abs(kt - kj) <= 1e-9
    assert t._last_outers == j._last_outers and abs(t._last_inners - j._last_inners) <= 2
    assert abs(t.SolveKeff() - j.SolveKeff()) <= 1e-9  # the exact context, kept beside it
    with pytest.warns(RuntimeWarning, match="diag_elementwise"):
        t.SolveKeff(use_diagonal_solver=True, diag_elementwise=True)
    assert t._last_inners == 0
    with pytest.raises(ValueError):
        t.SolveKeff(diag_elementwise=True)


def test_direct_llt_under_diagonal_solver_matches_jax():
    """DIRECT_LLT with the diagonal solver: the dense Schur of the "diag"
    A-solve, factored on the "diag" context, both facades."""
    from neutfem_tpu_torch.compat import LinearSolverType

    j, t = _facades(LinearSolverType.DIRECT_LLT)
    kj = j.SolveKeff(use_diagonal_solver=True)
    kt = t.SolveKeff(use_diagonal_solver=True)
    assert "schur_chol" in t._ctxs["diag"] and "schur_chol" not in t._ctx
    assert abs(kt - kj) <= 1e-9 and t._last_outers == j._last_outers


def test_main_variants_on_the_cpu():
    """bench.main_variants' device="cpu" form: the diagonal rows on IAEA-3D
    1x1, one row each, no kernel launched, the bug-compat row warning with
    0 inners."""
    from neutfem_tpu_torch import bench

    rows = bench.main_variants(("diag", "diag_elementwise"), mesh=(1, 1), device="cpu",
                               dtype=F64)
    assert [r["row"] for r in rows] == ["diag", "diag_elementwise"]
    for r in rows:
        assert r["detail"]["launches"] == {} and np.isfinite(r["detail"]["keff"])
    assert rows[1]["detail"]["inner_iterations"] == 0
    assert any("diag_elementwise" in w for w in rows[1]["detail"]["warnings"])
