"""The port's BiCGSTAB against neutfem_tpu's, at float64 on the CPU.

* ``krylov.bicgstab`` on an SPD and a non-symmetric system: the same
  iteration count and x to rel 1e-12; the zero-rhs and breakdown guards;
  blocks of 4 iterations per host read equal one a read, bit for bit (the
  masked step keeps the state of the ``while_loop`` after the stop);
* ``inner_solver="bicgstab"`` in ``power_iteration`` and CMFD "wielandt"
  (small random problems; the wielandt one's low-order eigensolve converges):
  |dk| <= 1e-9, the same outers, inners within 2;
* the facade's BICGSTAB solver type still runs the CG, as the JAX facade's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.krylov import bicgstab as j_bicgstab
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu_torch import krylov
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, power_iteration

torch.set_num_threads(1)

F64 = torch.float64


def _system(symmetric: bool, n=40, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    A = M @ M.T + np.eye(n) if symmetric else np.eye(n) * 2.0 + 0.6 * M
    return A, rng.standard_normal(n), rng.standard_normal(n) * 0.1


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("precond", [False, True])
def test_bicgstab_matches_jax(symmetric, precond):
    A, b, x0 = _system(symmetric)
    dinv = 1.0 / np.diag(A)
    jpc = (lambda r: r * jnp.asarray(dinv)) if precond else None
    tpc = (lambda r: r * torch.tensor(dinv)) if precond else None
    want = j_bicgstab(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), jnp.asarray(x0),
                      precond=jpc, tol=1e-10, maxiter=200)
    got = krylov.bicgstab(lambda x: torch.tensor(A) @ x, torch.tensor(b), torch.tensor(x0),
                          precond=tpc, tol=1e-10, maxiter=200)
    assert got.iterations == int(want.iterations)
    x = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - x)) / np.max(np.abs(x)) <= 1e-12
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-6)
    assert float(got.residual) <= 1e-10


def test_bicgstab_guards():
    """A zero rhs gives x = 0 and residual 0 from a warm start (both
    packages); a zero operator trips the breakdown guard after one iteration
    with a finite x."""
    A, _, _ = _system(True, n=16)
    mv = lambda x: torch.tensor(A) @ x
    res = krylov.bicgstab(mv, torch.zeros(16, dtype=F64), torch.ones(16, dtype=F64), tol=1e-8,
                          maxiter=50)
    assert float(torch.max(torch.abs(res.x))) == 0.0 and float(res.residual) == 0.0
    jres = j_bicgstab(lambda x: jnp.asarray(A) @ x, jnp.zeros(16), jnp.ones(16), tol=1e-8,
                      maxiter=50)
    assert res.iterations == int(jres.iterations)
    b = torch.ones(32, dtype=torch.float32)
    res = krylov.bicgstab(lambda x: torch.zeros_like(x), b, torch.zeros_like(b), tol=1e-8,
                          maxiter=100)
    jres = j_bicgstab(lambda x: jnp.zeros_like(x), jnp.ones(32, jnp.float32),
                      jnp.zeros(32, jnp.float32), tol=1e-8, maxiter=100)
    assert res.iterations == int(jres.iterations) <= 1
    assert bool(torch.all(torch.isfinite(res.x)))


@pytest.mark.parametrize("symmetric", [True, False])
def test_bicgstab_blocks_equal_one_step(symmetric):
    """Blocks of 4 iterations per host read run the frozen tail after the stop
    test fails; the result is the one-a-read loop's bit for bit (x, the
    residual, the count), also when maxiter stops it."""
    A, b, x0 = _system(symmetric, seed=3)
    mv = lambda x: torch.tensor(A) @ x
    for maxiter in (200, 7):
        one = krylov.bicgstab_blocks(mv, torch.tensor(b), torch.tensor(x0), tol=1e-10,
                                     maxiter=maxiter, block=1)
        four = krylov.bicgstab_blocks(mv, torch.tensor(b), torch.tensor(x0), tol=1e-10,
                                      maxiter=maxiter, block=4)
        assert one.iterations == four.iterations
        assert one.iterations % 4 != 0 or maxiter == 7  # a block runs frozen iterations
        assert torch.equal(one.x, four.x) and torch.equal(one.residual, four.residual)


def test_bicgstab_inner_solver_matches_jax():
    """inner_solver="bicgstab" in power_iteration, a random 2D problem."""
    fes, jctx, tctx = _problem((1, 3, 4), periodic=False)
    kw = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=100,
              inner_solver="bicgstab")
    want = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx,
                                      jnp.ones((2, *fes.mesh.shape, 1)), 1.0)
    got = power_iteration(fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, *fes.mesh.shape, 1), dtype=F64), 1.0)
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= 2


def _problem(shape, periodic: bool):
    """A random 2-group problem (2D where nz = 1), float64, its highest
    direction PERIODIC or vacuum: (fes, JAX context, port context)."""
    rng = np.random.default_rng(4)
    nz, ny, nx = shape
    dim = 2 if nz == 1 else 3
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
          for n in (nx, ny, nz)[:dim]])
    fes = j_fespace.make_fespace(mesh, 0, 0)
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            kind = BCKind.PERIODIC if (periodic and ax == dim - 1) else BCKind.DIRICHLET
            bcs.set(j_mesh.boundary_attribute(dim, ax, up), kind)
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    return fes, jctx, ctx_from_numpy({k: np.asarray(v) for k, v in jctx.items()}, "cpu", F64)


def test_cmfd_wielandt_matches_jax():
    """CMFD "wielandt" (the low-order eigensolve by BiCGSTAB) with the
    wrap-around neighbours of a periodic direction: a problem where the
    experimental eigensolve converges (on vacuum boundaries this one walks
    off in both packages)."""
    fes, jctx, tctx = _problem((1, 4, 5), periodic=True)
    kw = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=60, accel="none",
              use_cmfd=True, cmfd_mode="wielandt", cmfd_lo_outers=20)
    want = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx,
                                      jnp.ones((2, *fes.mesh.shape, 1)), 1.0)
    got = power_iteration(fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, *fes.mesh.shape, 1), dtype=F64), 1.0)
    assert int(want["outer_iterations"]) < 60  # the lo eigensolve converged here
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= 2


def test_facade_bicgstab_type_runs_cg():
    """LinearSolverType.BICGSTAB (the reference default) resolves to the CG in
    both facades; BiCGSTAB is reached through SolveOptions and CMFD only."""
    from neutfem_tpu_torch.compat import LinearSolverType, NeutFEM

    s = NeutFEM(0, 2, *(np.linspace(0.0, 3.0, 4),) * 3, device="cpu", dtype=F64)
    s.set_linear_solver(LinearSolverType.BICGSTAB_DIAG)
    assert s._inner_solver() == "cg" and s._opts(s._inner_solver()).inner_solver == "cg"
    with pytest.raises(ValueError):
        s.set_acceleration("wielandt")
