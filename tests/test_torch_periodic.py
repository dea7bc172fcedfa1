"""PERIODIC boundaries in the port against neutfem_tpu, at float64 on the CPU.

A periodic direction ties face n to face 0; the n distinct faces form a
cyclic tridiagonal system, solved by Sherman-Morrison on the LDL^T Thomas
solve (``ops/context.py``, ``ops/apply.solve_A_dir``).  Held here:

* the context's cyclic data (``cyc_wt`` / ``cyc_a0`` / ``cyc_a1``, the
  factors, the wrap-around ``dtilde``, the diag-A ``precond_inv`` a periodic
  direction keeps) against the JAX ``build_context`` (rel <= 1e-12);
* the cyclic ``solve_A_dir`` and the Schur matvec against the JAX ones with
  the same data (rel <= 1e-12), RT0 and RT1;
* the uniform 1D lattice at k_inf; 2D and 3D RT1-P1 ``power_iteration`` and a
  periodic direction under CMFD against JAX (|dk| <= 1e-9, the same outers,
  inners within 2 — within 1% at RT1, whose periodic group systems amplify
  rounding: see that test);
* ``periodic_natural`` (reference parity: a warning, then a natural
  boundary) and the refused configurations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.ops.apply import apply_BT_dir as j_apply_BT_dir
from neutfem_tpu.ops.apply import cyc_args as j_cyc_args
from neutfem_tpu.ops.apply import solve_A_dir as j_solve_A_dir
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch.ops.apply import cyc_args, schur_matvec, solve_A_dir
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, ctx_group, power_iteration

torch.set_num_threads(1)

F64 = torch.float64
P, D, M = BCKind.PERIODIC, BCKind.DIRICHLET, BCKind.MIRROR


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _problem(shape, k=0, periodic=(0,), mirror=(), seed=0):
    """A random 2-group problem on ``shape`` (nz, ny, nx; 2D where nz = 1, 1D
    where ny = 1 too), its axes ``periodic`` PERIODIC and ``mirror`` MIRROR,
    the rest vacuum: (fes, xs, bcs)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    dim = 1 if ny == 1 else 2 if nz == 1 else 3
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
          for n in (nx, ny, nz)[:dim]])
    fes = j_fespace.make_fespace(mesh, k, k)
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            kind = P if ax in periodic else M if ax in mirror else D
            bcs.set(j_mesh.boundary_attribute(dim, ax, up), kind)
    return fes, xs, bcs


def _contexts(fes, xs, bcs):
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    return jctx, ctx_from_numpy({k: np.asarray(v) for k, v in jctx.items()}, "cpu", F64)


@pytest.mark.parametrize("k", [0, 1])
def test_periodic_context_matches_jax(k):
    """The port's build_context: every key the JAX one has, the cyclic data,
    the wrap-around dtilde and the diag-A precond_inv of a periodic
    direction included; at k = 1 also the T-broadcast factors."""
    fes, xs, bcs = _problem((3, 4, 5), k, periodic=(0, 2), mirror=(1,))
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(fes, 2, xs, bcs, "cpu", F64)
    for key in ("cyc_wt_d0", "cyc_a0_d0", "cyc_a1_d0", "cyc_wt_d2", "dtilde_d0", "dtilde_d2",
                "precond_inv", "tri_dinv_d0", "tri_l_d2", "mask_d0"):
        assert key in tctx
    for key, v in jctx.items():
        if key.startswith("tri_hoxT_"):  # lane-packed in the JAX package
            continue
        assert tuple(tctx[key].shape) == tuple(v.shape), key
        assert np.max(np.abs(tctx[key].numpy() - np.asarray(v))) <= (
            1e-12 * max(np.max(np.abs(np.asarray(v))), 1e-300)), key
    extra = set(tctx) - set(jctx)
    assert extra == ({f"tri_cycT_{n}_d{d}" for n in ("dinv", "l") for d in (0, 2)}
                     if k else set())
    for d in (0, 2):
        if k:
            T = tctx[f"tri_cycT_dinv_d{d}"].shape[1]
            assert torch.equal(tctx[f"tri_cycT_dinv_d{d}"][:, T - 1], tctx[f"tri_dinv_d{d}"])


@pytest.mark.parametrize("k", [0, 1])
def test_cyclic_solve_A_dir_matches_jax(k):
    """solve_A_dir on a periodic direction (faces folded, the cyclic
    Sherman-Morrison solve, re-expanded; at k = 1 with the bubble rhs), the
    same rhs and context data as the JAX solve_A_dir."""
    fes, xs, bcs = _problem((3, 4, 5), k, periodic=(0, 1))
    jctx, tctx = _contexts(fes, xs, bcs)
    rng = np.random.default_rng(1)
    phi = rng.standard_normal((2, fes.P, *fes.mesh.shape))
    for di in fes.dirs:
        key = f"d{di.d}"
        rF, rW = j_apply_BT_dir(fes, di, jnp.asarray(phi))
        F, W = j_solve_A_dir(fes, di, jctx[f"tri_dinv_{key}"], jctx.get(f"tri_l_{key}"),
                             jctx[f"mask_{key}"], jctx[f"alpha_{key}"], rF, rW, "exact",
                             cyc=j_cyc_args(jctx, key))
        tW = None if rW is None else torch.tensor(np.asarray(rW))
        got = solve_A_dir(fes, di, tctx[f"tri_dinv_{key}"], tctx[f"tri_l_{key}"],
                          tctx[f"mask_{key}"], tctx[f"alpha_{key}"],
                          torch.tensor(np.asarray(rF)), tW, "exact", cyc=cyc_args(tctx, key))
        assert (cyc_args(tctx, key) is None) == (di.d == 2)
        assert _rel(got[0].numpy(), F) <= 1e-12, key
        if W is not None:
            assert _rel(got[1].numpy(), W) <= 1e-12, key
        if di.d != 2:  # the tied face repeats face 0
            n = got[0].shape[di.axis - 3]
            assert torch.equal(got[0].narrow(di.axis - 3, n - 1, 1),
                               got[0].narrow(di.axis - 3, 0, 1))


@pytest.mark.parametrize("k", [0, 1])
def test_periodic_schur_matvec_matches_jax(k):
    """One group's Schur matvec with two periodic directions (the unfused
    cyclic chain there, the fused paths' plain versions elsewhere) and the
    unfused one, against the JAX matvec."""
    fes, xs, bcs = _problem((3, 4, 5), k, periodic=(0, 1))
    jctx, tctx = _contexts(fes, xs, bcs)
    tctx = build_context(fes, 2, xs, bcs, "cpu", F64)  # with the T-broadcast factors
    v = np.random.default_rng(2).standard_normal((fes.P, *fes.mesh.shape))
    want = jax_jitted.schur_matvec(fes, j_ctx_group(jctx, 1), jnp.asarray(v), "exact")
    for fused in (True, False):
        got = schur_matvec(fes, ctx_group(tctx, 1), torch.tensor(v), "exact", fused=fused)
        assert _rel(got.numpy(), want) <= 1e-12


def test_uniform_1d_lattice_is_kinf():
    """A uniform periodic medium: k = k_inf, the flux flat (the cyclic solve
    must not perturb the fundamental mode)."""
    nx = 16
    mesh = j_mesh.CartesianMesh.from_breaks(np.linspace(0, 32.0, nx + 1))
    fes = j_fespace.make_fespace(mesh, 0, 0)
    shape = (1, 1, nx)
    xs = {"D": np.stack([np.full(shape, 1.4), np.full(shape, 0.4)]),
          "SigR": np.stack([np.full(shape, 0.028), np.full(shape, 0.10)]),
          "NSF": np.stack([np.full(shape, 0.005), np.full(shape, 0.135)]),
          "Chi": np.stack([np.ones(shape), np.zeros(shape)]),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["SigS"][1, 0] = 0.018
    bcs = BCSpec()
    for up in (False, True):
        bcs.set(j_mesh.boundary_attribute(1, 0, up), P)
    ctx = build_context(fes, 2, xs, bcs, "cpu", F64)
    res = power_iteration(fes, 2, SolveOptions(tol_keff=1e-10, tol_flux=1e-9, inner_tol=1e-12,
                                               max_outer=400), ctx,
                          torch.ones((2, *mesh.shape, 1), dtype=F64), 1.0)
    kinf = 0.005 / 0.028 + 0.135 * 0.018 / (0.028 * 0.10)
    assert float(res["keff"]) == pytest.approx(kinf, abs=5e-10)
    phi = res["phi"][0, ..., 0]
    assert float((phi.max() - phi.min()) / phi.max()) < 1e-7


@pytest.mark.parametrize("shape,periodic", [((1, 3, 4), (1,)), ((2, 2, 3), (0,))])
def test_periodic_rt1_power_iteration_matches_jax(shape, periodic):
    """RT1-P1 power iterations with a periodic direction, 2D and 3D: k to
    1e-9, the same outers; the inner totals within 1%, not 2 iterations.
    These group systems amplify rounding (on the 3x4x5 RT1 problem of
    test_cyclic_solve_A_dir_matches_jax the two packages' CG iterates agree
    to 1e-15 after 5 iterations, 1e-10 after 20, 5e-3 after 50, with either
    preconditioner and a symmetric operator), so the count moves with any
    change of rounding: on this 2D problem the JAX package alone gives 3916,
    3912 and 3908 inners from start fluxes 1e-15 apart, the port 3897-3904."""
    fes, xs, bcs = _problem(shape, 1, periodic=periodic, seed=5)
    jctx, tctx = _contexts(fes, xs, bcs)
    kw = dict(tol_keff=1e-9, tol_flux=1e-7, inner_tol=1e-9, max_outer=100)
    want = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx,
                                      jnp.ones((2, *fes.mesh.shape, fes.P)), 1.0)
    got = power_iteration(fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, *fes.mesh.shape, fes.P), dtype=F64), 1.0)
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= (
        0.01 * int(want["inner_iterations"]))
    assert _rel(got["J"]["d0"]["face"].numpy(), want["J"]["d0"]["face"]) <= 1e-7


def test_periodic_cmfd_matches_jax():
    """CMFD "fixed" with a periodic direction: the Dhat closure and the
    low-order operator wrap around the seam."""
    fes, xs, bcs = _problem((1, 4, 5), 0, periodic=(1,), seed=6)
    jctx, tctx = _contexts(fes, xs, bcs)
    kw = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=100, use_cmfd=True)
    want = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx,
                                      jnp.ones((2, *fes.mesh.shape, 1)), 1.0)
    got = power_iteration(fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, *fes.mesh.shape, 1), dtype=F64), 1.0)
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= 2


def test_periodic_natural_warns_and_acts_natural():
    """Reference parity: PERIODIC treated as a natural zero-flux boundary with
    a warning; the context is the JAX one's, and that of a NONE boundary."""
    fes, xs, bcs = _problem((3, 4, 5), 0, periodic=(0,))
    with pytest.warns(RuntimeWarning, match="periodic_natural"):
        tctx = build_context(fes, 2, xs, bcs, "cpu", F64, periodic_natural=True)
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64,
                           periodic_natural=True)
    assert "cyc_wt_d0" not in tctx
    for key in ("tri_dinv_d0", "precond_inv", "dtilde_d0"):
        assert _rel(tctx[key].numpy(), jctx[key]) <= 1e-12
    natural = BCSpec(kinds={a: k for a, k in bcs.kinds.items() if k != P},
                     values=dict(bcs.values))
    plain = build_context(fes, 2, xs, natural, "cpu", F64)
    assert torch.equal(plain["tri_dinv_d0"], tctx["tri_dinv_d0"])


@pytest.mark.parametrize("case", ["one_end", "a_mode", "one_cell"])
def test_periodic_refused(case):
    """PERIODIC on one end only, under a_mode "diag", or along a direction
    of one cell raises ValueError, as in the JAX package."""
    shape = (3, 4, 1) if case == "one_cell" else (3, 4, 5)
    fes, xs, bcs = _problem(shape, 0, periodic=(0,))
    if case == "one_end":
        bcs.set(j_mesh.boundary_attribute(3, 0, True), D)
    kw = {"a_mode": "diag"} if case == "a_mode" else {}
    with pytest.raises(ValueError):
        j_build_context(fes, 2, xs, bcs, dtype=jnp.float64, **kw)
    with pytest.raises(ValueError):
        build_context(fes, 2, xs, bcs, "cpu", F64, **kw)
