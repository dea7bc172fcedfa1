"""The port's line preconditioner and K4′ against neutfem_tpu on the CPU.

* the line factors precond_line_* / precond_line2_* of build_context in 2D and
  3D, key by key (rel <= 1e-12: the same float64 numpy arithmetic);
* group_solve in "line" and "line2" (identical CG iteration count, rel(x) <=
  1e-10) and power_iteration with the line preconditioner (|dk| <= 1e-9,
  identical outers, inners within 2: the two packages sum their dot products
  in different orders, which can flip one CG stop test that sits on a tie);
* the "auto" rule (power.resolve_precond) against the JAX package's order;
* K4′: ops/thomas.wide_rows against the layouts the JAX package dispatches to
  its ``_solve_y`` kernel, and the wrapper on CPU tensors (its plain version)
  against that kernel in interpret mode (rel <= 1e-12 at float64, 1e-5 at
  float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops import pallas_tridiag as j_pallas_tridiag
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.native import tridiag_ldlt_batch
from neutfem_tpu_torch.ops import thomas
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import (SolveOptions, ctx_group, group_solve, power_iteration,
                                     resolve_precond)

torch.set_num_threads(1)

F64 = torch.float64
LINE_KEYS = {f"precond_{n}_{p}" for n in ("line", "line2") for p in ("dinv", "l")}


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _problem(shape, case="mirror", seed=0, ng=2):
    """(JAX fes, port fes, JAX ctx, port ctx) of one random problem on a
    (nz, ny, nx) mesh (2D when nz == 0), float64."""
    rng = np.random.default_rng(seed)
    dim = 3 if shape[0] else 2
    grid = tuple(s or 1 for s in shape)
    nz, ny, nx = shape
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (nx, ny)]
    breaks.append(np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, nz))])
                  if dim == 3 else None)
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *grid)), "SigR": rng.uniform(0.01, 0.2, (ng, *grid)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *grid)), "Chi": np.zeros((ng, *grid)),
          "SigS": np.zeros((ng, ng, *grid)), "SRC": np.zeros((ng, *grid))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, grid)
    jb, tb = JBCSpec(), BCSpec()
    for ax in range(dim):
        for up in (False, True):
            kind = "MIRROR" if (case == "mirror" and not up) else "DIRICHLET"
            jb.set(j_mesh.boundary_attribute(dim, ax, up), JBCKind[kind])
            tb.set(t_mesh.boundary_attribute(dim, ax, up), BCKind[kind])
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=F64)
    return jfes, tfes, jctx, tctx


@pytest.mark.parametrize("shape,case", [((0, 9, 11), "mirror"), ((0, 9, 11), "dirichlet"),
                                        ((5, 6, 7), "mirror"), ((5, 6, 7), "dirichlet")])
def test_line_factors_match_jax(shape, case):
    _, _, jctx, tctx = _problem(shape, case)
    assert LINE_KEYS <= set(tctx) and LINE_KEYS <= set(jctx)
    for k in LINE_KEYS:
        assert tctx[k].dtype == F64 and tctx[k].is_contiguous()
        assert _rel(tctx[k].numpy(), np.asarray(jctx[k])) <= 1e-12, k


def test_no_line_factors_at_higher_order():
    mesh = t_mesh.CartesianMesh.from_breaks(np.linspace(0, 4, 5), np.linspace(0, 3, 4))
    fes = t_fespace.make_fespace(mesh, 1, 1)
    xs = {"D": np.ones((1, 1, 3, 4)), "SigR": np.full((1, 1, 3, 4), 0.1),
          "NSF": np.zeros((1, 1, 3, 4)), "Chi": np.ones((1, 1, 3, 4)),
          "SigS": np.zeros((1, 1, 1, 3, 4)), "SRC": np.zeros((1, 1, 3, 4))}
    ctx = build_context(fes, 1, xs, BCSpec(), device="cpu", dtype=F64)
    assert not LINE_KEYS & set(ctx)


@pytest.mark.parametrize("shape", [(0, 14, 12), (6, 7, 8)])
@pytest.mark.parametrize("mode", ["line", "line2"])
def test_group_solve_line_matches_jax(shape, mode):
    jfes, tfes, jctx, tctx = _problem(shape, seed=1)
    rng = np.random.default_rng(2)
    rhs, x0 = rng.standard_normal((2, 1, *tfes.mesh.shape))
    kw = dict(inner_precond=mode, inner_tol=1e-10, max_inner=500)
    jres = jax_jitted.group_solve(jfes, j_ctx_group(jctx, 0), JSolveOptions(**kw),
                                  jnp.asarray(rhs), jnp.asarray(x0))
    tres = group_solve(tfes, ctx_group(tctx, 0), SolveOptions(**kw), torch.tensor(rhs),
                       torch.tensor(x0))
    assert tres.iterations == int(jres.iterations) > 3
    assert _rel(tres.x.numpy(), np.asarray(jres.x)) <= 1e-10


@pytest.mark.parametrize("shape,mode", [((0, 15, 13), "line"), ((5, 6, 7), "line"),
                                        ((5, 6, 7), "line2")])
def test_power_iteration_line_matches_jax(shape, mode):
    jfes, tfes, jctx, tctx = _problem(shape, seed=3)
    kw = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-7, inner_eta=0.03, max_outer=150,
              inner_precond=mode)
    phi0 = np.ones((2, *tfes.mesh.shape, 1))
    jres = jax_jitted.power_iteration(jfes, 2, JSolveOptions(**kw), jctx, jnp.asarray(phi0), 1.0)
    tres = power_iteration(tfes, 2, SolveOptions(**kw), tctx, torch.tensor(phi0), 1.0)
    assert abs(float(tres["keff"]) - float(jres["keff"])) <= 1e-9
    assert tres["outer_iterations"] == int(jres["outer_iterations"]) < 150
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-7


def test_auto_rule_follows_the_jax_order():
    """A coarse level (P == 1) -> twogrid; P > 1 -> block; >= 3M cells -> line
    (IAEA-3D 8x8x8: 152^3 = 3,511,808 cells); else jacobi.  An explicit mode
    passes through."""
    small = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(
        np.linspace(0, 4, 5), np.linspace(0, 3, 4), np.linspace(0, 2, 3)), 0, 0)
    ho = t_fespace.make_fespace(small.mesh, 1, 1)
    b = np.linspace(0.0, 304.0, 153)
    big = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(b, b, b), 0, 0)
    assert resolve_precond(small, {}, "auto") == "jacobi"
    assert resolve_precond(small, {"tg": {}}, "auto") == "twogrid"
    assert resolve_precond(ho, {"tg": {}}, "auto") == "block"
    assert resolve_precond(big, {}, "auto") == "line"
    assert resolve_precond(big, {"tg": {}}, "auto") == "twogrid"
    assert resolve_precond(small, {}, "line2") == "line2"


def _recording(monkeypatch):
    """Replace the JAX dispatch's kernels by recorders; returns the log."""
    calls = []
    for name in ("_solve_z", "_solve_rows", "_solve_y", "_solve_transpose"):
        def fake(r, *args, _name=name, **kw):
            calls.append(_name)
            return r
        monkeypatch.setattr(j_pallas_tridiag, name, fake)
    return calls


@pytest.mark.parametrize("shape,axis", [
    ((2, 1, 1, 913, 912), -2),   # compute_current, ZION 48x48 y: K4'
    ((1, 1, 912, 912), -2),      # the 2D line preconditioner at ZION 48x48: K4'
    ((4, 1, 1, 545, 544), -2),   # compute_current, KOEBERG 32x32 y: K4'
    ((2, 1, 76, 115, 114), -2),  # compute_current, IAEA-3D 6x6x4 y: rows
    ((1, 1, 1, 257, 256), -2),   # just wide: K4'
    ((1, 1, 1, 255, 256), -2),   # just narrow: rows
    ((2, 1, 77, 114, 114), -3),  # z
    ((2, 1, 1, 912, 913), -1),   # x
])
def test_wide_rows_matches_the_jax_dispatch(monkeypatch, shape, axis):
    calls = _recording(monkeypatch)
    lshape = list(shape)
    lshape[axis] -= 1
    r = jnp.zeros(shape, jnp.float32)
    assert j_pallas_tridiag.thomas_solve(r, r, jnp.zeros(lshape, jnp.float32), axis) is not None
    assert thomas.wide_rows(shape, axis) == (calls == ["_solve_y"])


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_plain_thomas_matches_jax_solve_y(prec):
    """K4′'s plain version (the wrapper on CPU tensors) against the JAX package's
    _solve_y in interpret mode at a wide 2D layout."""
    shape, axis = (2, 1, 1, 257, 272), -2
    assert thomas.wide_rows(shape, axis)
    jdt, tdt, ndt, tol = {"f64": (jnp.float64, F64, np.float64, 1e-12),
                          "f32": (jnp.float32, torch.float32, np.float32, 1e-5)}[prec]
    rng = np.random.default_rng(4)
    lshape = list(shape)
    lshape[axis] -= 1
    dinv, l = (np.moveaxis(a, -1, axis) for a in tridiag_ldlt_batch(
        np.moveaxis(rng.uniform(2.0, 3.0, shape), axis, -1),
        np.moveaxis(rng.uniform(-0.5, 0.5, lshape), axis, -1)))
    rhs, dinv, l = (a.astype(ndt) for a in (rng.standard_normal(shape), dinv, l))
    calls = []
    solve_y = j_pallas_tridiag._solve_y

    def spy(*args, **kw):
        calls.append("_solve_y")
        return solve_y(*args, **kw)

    j_pallas_tridiag._solve_y = spy
    try:
        want = j_pallas_tridiag.thomas_solve(jnp.asarray(rhs), jnp.asarray(dinv),
                                             jnp.asarray(l), axis, interpret=True)
    finally:
        j_pallas_tridiag._solve_y = solve_y
    assert calls == ["_solve_y"]
    got = thomas.thomas_solve(*(torch.tensor(np.ascontiguousarray(a), dtype=tdt)
                                for a in (rhs, dinv, l)), axis)
    assert _rel(got.numpy(), np.asarray(want)) <= tol
