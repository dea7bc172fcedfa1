"""Anderson acceleration of the port against neutfem_tpu at float64 on the CPU.

* ``accel.anderson_apply`` against the JAX ``anderson_apply`` on seeded
  histories, step by step from an empty buffer (the first pair, where the
  update is the image itself, included), on a contracting fixed-point
  sequence and on one whose step the relative clip cuts: every iterate to
  rel 1e-12;
* ``power_iteration(accel="anderson")`` on a random 2-group 3D problem at
  RT0-P0 and RT1-P1: the direct solve, the adjoint, the solve at a fixed
  eigenvalue and the Jacobi group sweep (where Chebyshev is off and Anderson
  is not): |dk| <= 1e-9, identical outer counts, inner totals within 2;
* both facades under ``set_acceleration("anderson")`` on IAEA-2D and KOEBERG
  2x2: |dk| <= 1e-9 and the same outer count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import accel as j_accel
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu_torch import accel
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import SolveOptions, power_iteration

torch.set_num_threads(1)

F64 = torch.float64
TOL = (1e-6, 1e-5, 1e-5, 300, 1000)  # the benchmark tests' tolerances


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _sequence(case, n, steps, rng):
    """(x_prev, g(x_prev)) pairs: a contracting affine map x -> A x + b
    ("contract"), or images far from their iterates, so that the step is
    clipped to 0.3 of ||g(x)|| ("clip")."""
    if case == "contract":
        A = 0.6 * rng.standard_normal((n, n)) / np.sqrt(n)
        b = rng.standard_normal(n)
        return lambda x: A @ x + b
    return lambda x: 50.0 * rng.standard_normal(n)


@pytest.mark.parametrize("case", ["contract", "clip"])
def test_anderson_apply_matches_jax(case):
    rng = np.random.default_rng(11 if case == "contract" else 12)
    n, m, steps = 40, 4, 8
    g = _sequence(case, n, steps, rng)
    jstate = j_accel.anderson_init(n, m, jnp.float64)
    tstate = accel.anderson_init(n, m, F64, "cpu")
    x = rng.standard_normal(n)
    clipped = 0
    for i in range(steps):
        gx = g(x)
        jstate, jx = j_accel.anderson_apply(jstate, jnp.asarray(x), jnp.asarray(gx))
        tstate, tx = accel.anderson_apply(tstate, torch.tensor(x), torch.tensor(gx))
        jx = np.asarray(jx)
        assert tstate.it == int(jstate.it) == i + 1
        assert _rel(tstate.X.numpy(), np.asarray(jstate.X)) <= 1e-15
        assert _rel(tx.numpy(), jx) <= 1e-12
        if i == 0:
            assert np.array_equal(tx.numpy(), gx)  # one pair: the image itself
        elif np.linalg.norm(jx - gx) >= 0.3 * np.linalg.norm(gx) * (1 - 1e-12):
            clipped += 1
        x = jx
    assert clipped >= (steps - 2 if case == "clip" else 0)


def _pair(shape, k, seed):
    """(JAX fes, JAX ctx, port fes, port ctx) of one random 2-group RT_k-P_k
    problem, float64: MIRROR on the lower faces, vacuum on the upper."""
    rng = np.random.default_rng(seed)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
              for n in shape[::-1]]
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    jb, tb = JBCSpec(), BCSpec()
    for ax in range(3):
        for up in (False, True):
            kind = "DIRICHLET" if up else "MIRROR"
            jb.set(j_mesh.boundary_attribute(3, ax, up), JBCKind[kind])
            tb.set(t_mesh.boundary_attribute(3, ax, up), BCKind[kind])
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), k, k)
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), k, k)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=F64)
    return jfes, jctx, tfes, tctx


#: tolerances of the power-iteration cases (the Anderson step starts at outer 2)
KW = dict(accel="anderson", tol_keff=1e-7, tol_flux=1e-6, inner_tol=1e-8, max_outer=200)


@pytest.fixture(scope="module", params=[0, 1], ids=["rt0", "rt1"])
def problem(request):
    """The problem and the port's direct k (the fixed eigenvalue of the
    fixed_keff case)."""
    k = request.param
    jfes, jctx, tfes, tctx = _pair((3, 4, 5) if k == 0 else (2, 3, 3), k, seed=21 + k)
    res = power_iteration(tfes, 2, SolveOptions(**KW), tctx,
                          torch.ones((2, *tfes.mesh.shape, tfes.P), dtype=F64), 1.0)
    return jfes, jctx, tfes, tctx, float(res["keff"])


@pytest.mark.parametrize("mode", ["direct", "adjoint", "fixed_keff", "jacobi"])
def test_power_iteration_anderson_matches_jax(problem, mode):
    jfes, jctx, tfes, tctx, k_direct = problem
    kw = dict(KW, sweep="jacobi" if mode == "jacobi" else "gs")
    shape = (2, *tfes.mesh.shape, tfes.P)
    keff0 = k_direct if mode == "fixed_keff" else 1.0
    call = dict(adjoint=mode == "adjoint", fixed_keff=keff0 if mode == "fixed_keff" else None)
    jres = jax_jitted.power_iteration(jfes, 2, JSolveOptions(**kw), jctx, jnp.ones(shape),
                                      keff0, **call)
    tres = power_iteration(tfes, 2, SolveOptions(**kw), tctx, torch.ones(shape, dtype=F64),
                           keff0, **call)
    outers = int(jres["outer_iterations"])
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["outer_iterations"] == outers
    assert 2 < outers < 200
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-6


@pytest.mark.parametrize("core", ["iaea2d", "koeberg2d"])
def test_facade_anderson_matches_jax(core):
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    spec = BENCHMARKS[core]
    runs = (JRun(spec, mesh_n=2), BenchmarkRun(spec, mesh_n=2, device="cpu", dtype=F64))
    out = []
    for run in runs:
        run.solver.set_acceleration("anderson")
        out.append((run.solve(tol=TOL), run.solver._last_outers, run.solver._last_inners))
    (kj, oj, ij), (kt, ot, it) = out
    assert abs(kt - kj) <= 1e-9
    assert ot == oj
    assert abs(it - ij) <= 2


def test_set_acceleration_rejects_unknown_kinds():
    from neutfem_tpu_torch.compat import NeutFEM

    s = NeutFEM(0, 1, np.linspace(0.0, 2.0, 3), [0.0], [0.0], device="cpu", dtype=F64)
    for kind in ("none", "Chebyshev", "ANDERSON"):
        s.set_acceleration(kind)
        assert s._opts().accel == kind.lower()
    with pytest.raises(ValueError):
        s.set_acceleration("wielandt")
