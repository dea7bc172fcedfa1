"""The equilibration-folded RT0 matvec (K7, ``NEUTFEM_EQFOLD``) and the
Chronopoulos-Gear CG (``NEUTFEM_CGCG``) of neutfem_tpu_torch against the JAX package.

* the eq context keys (``precond_eq_sdi``, ``precond_eq_csdi``) against JAX's;
* each of the five K7 wrappers (``ops/fused_eq.py``; on a CPU tensor its plain
  version) against the JAX Pallas kernel run in interpret mode at (8, 64, 64),
  where every JAX eq gate engages;
* ``equilibrated_schur_matvec`` in both modes against JAX's (interpret) and
  against the classic sdi * S(sdi * y), and the gate's declines;
* ``krylov.pcg_fused`` against the JAX ``pcg_fused``;
* IAEA-3D 1x1 RT0-P0 float64 through both facades under ``NEUTFEM_EQFOLD=1``,
  ``=2`` and ``NEUTFEM_CGCG=1``.  On a CPU the JAX package declines its eq
  kernels (no Pallas backend) and runs the classic matvec, while the port
  folds (its gate has no TPU tile limits), so this holds the fold to the
  same operator.

Tolerances are written beside each assertion.  The kernels themselves are
compared with the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops import pallas_fused as jpf
from neutfem_tpu.ops.apply import eqfold_available as j_eqfold_available
from neutfem_tpu.ops.apply import equilibrated_schur_matvec as j_eq_matvec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch import power as t_power
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops import fused_eq
from neutfem_tpu_torch.ops.apply import eqfold_available, equilibrated_schur_matvec, schur_matvec
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy
from neutfem_tpu_torch.power import ctx_group

torch.set_num_threads(1)

F64 = torch.float64
KERNEL_SHAPE = (8, 64, 64)  # (nz, ny, nx): every JAX eq kernel engages here
DT = {"f64": (jnp.float64, torch.float64, np.float64),
      "f32": (jnp.float32, torch.float32, np.float32)}


def _rel(got, want, base=0.0):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    base = np.asarray(base, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


def _problem(shape, k=0, seed=0, eqfold="2"):
    """(JAX fes, JAX ctx as float64 numpy, port fes, port ctx at float64, rng) of
    one random 2-group problem (MIRROR lower faces, Marshak upper), both
    contexts built under NEUTFEM_EQFOLD=``eqfold``."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (nx, ny, nz)]
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
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUTFEM_EQFOLD", eqfold)
        jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64)
        tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=F64)
    return jfes, {n: np.asarray(v) for n, v in jctx.items()}, tfes, tctx, rng


@pytest.mark.parametrize("eqfold", ["1", "2", "0"])
def test_eq_keys_match_jax(eqfold):
    """The eq operands exist under the switch only, equal JAX's at float64
    (rel 1e-13, the context tests' bound: the exact diag(S) is summed in
    another order), and ctx_from_numpy carries JAX's across."""
    _, jctx, _, tctx, _ = _problem((4, 5, 6), eqfold=eqfold)
    keys = ("precond_eq_sdi", "precond_eq_csdi")
    if eqfold == "0":
        assert not any(k in tctx or k in jctx for k in keys)
        return
    carried = ctx_from_numpy(jctx, "cpu", torch.float32)
    for k in keys:
        assert tctx[k].dtype == F64 and tctx[k].shape == (2, 1, 4, 5, 6)
        assert _rel(tctx[k].numpy(), jctx[k]) <= 1e-13, k
        assert carried[k].dtype == torch.float32
        assert np.array_equal(carried[k].numpy(), jctx[k].astype(np.float32)), k
    assert "precond_eq_sdi" in ctx_group(tctx, 1)


def test_eq_keys_only_at_rt0():
    """JAX builds them for k = m = 0 only; so does the port."""
    _, jctx, _, tctx, _ = _problem((3, 4, 5), k=1, eqfold="2")
    assert "precond_eq_sdi" not in tctx and "precond_eq_sdi" not in jctx


@pytest.fixture(scope="module")
def kernel_problem():
    """Group 1 of one problem at KERNEL_SHAPE: the JAX context (numpy, float64),
    the port's at both dtypes (carried from JAX's) and the direction coefficients."""
    jfes, jctx, tfes, _, rng = _problem(KERNEL_SHAPE, seed=5)
    jg = j_ctx_group(jctx, 1)
    tg = {p: ctx_group(ctx_from_numpy(jctx, "cpu", DT[p][1]), 1) for p in DT}
    dis = {di.d: di for di in tfes.dirs}
    coef = {d: (float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]))
            for d, di in dis.items()}
    return jfes, jg, tfes, tg, coef, rng


# float32: the JAX eq kernels' own test tolerance (tests/test_pallas_fused.py:147);
# float64: the same recurrence, only the association of a few products differs
TOL = {"f32": dict(rtol=3e-5, atol=3e-5), "f64": dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", ["x_eq", "z_eq", "x_eq2", "y_eq2", "z_eq2"])
def test_plain_eq_kernel_matches_jax_interpret(kernel_problem, name, prec):
    jfes, jg, tfes, tg, coef, rng = kernel_problem
    jdt, tdt, ndt = DT[prec]
    tg = tg[prec]
    shape = (1, *KERNEL_SHAPE)
    y, acc = (rng.standard_normal(shape).astype(ndt) for _ in range(2))

    def j(name_):  # a JAX context entry at the working dtype
        return jnp.asarray(jg[name_], jdt)

    def t(a):
        return torch.tensor(a, dtype=tdt)

    sdi, ce = "precond_eq_sdi", "precond_eq_csdi"
    xT, yT = ("tri_xT_dinvm_d0", "tri_xT_l_d0"), ("tri_yT_dinvm_d1", "tri_yT_l_d1")
    z = ("tri_dinvm_d2", "tri_l_d2")
    d = {"x": 0, "y": 1, "z": 2}[name[0]]
    c = coef[d]
    jy, jacc = jnp.asarray(y), jnp.asarray(acc)
    acc_t = t(acc)
    if name == "x_eq":
        want, want_u = jpf.fused_schur_x_eq(jy, j(sdi), j(ce), j(xT[0]), j(xT[1]), *c,
                                            interpret=True)
        got, got_u = fused_eq.fused_schur_x_eq(t(y), tg[sdi], tg[ce], tg[xT[0]], tg[xT[1]], *c)
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **TOL[prec])
    elif name == "x_eq2":
        want = jpf.fused_schur_x_eq2(jy, j(sdi), j(ce), j(xT[0]), j(xT[1]), *c, interpret=True)
        got = fused_eq.fused_schur_x_eq2(t(y), tg[sdi], tg[ce], tg[xT[0]], tg[xT[1]], *c)
    elif name == "y_eq2":
        want = jpf.fused_schur_y_eq2(jacc, jy, j(sdi), j(yT[0]), j(yT[1]), *c, interpret=True)
        got = fused_eq.fused_schur_y_eq2(acc_t, t(y), tg[sdi], tg[yT[0]], tg[yT[1]], *c)
        assert got is acc_t  # in place, like the aliased TPU kernel
    elif name == "z_eq":
        want = jpf.fused_schur_z_eq(jacc, jy, j(z[0]), j(z[1]), j(sdi), *c, interpret=True)
        got = fused_eq.fused_schur_z_eq(acc_t, t(y), tg[z[0]], tg[z[1]], tg[sdi], *c)
        assert got is acc_t
    else:
        want = jpf.fused_schur_z_eq2(jacc, jy, j(sdi), j(z[0]), j(z[1]), *c, interpret=True)
        got = fused_eq.fused_schur_z_eq2(acc_t, t(y), tg[sdi], tg[z[0]], tg[z[1]], *c)
        assert got is acc_t
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[prec])


@pytest.mark.parametrize("mode", ["1", "2"])
def test_equilibrated_matvec_matches_jax_and_classic(kernel_problem, monkeypatch, mode):
    """Both fold modes against the JAX chain (interpret) and the classic
    sdi * S(sdi * y) at float64: rel 1e-12 (the same operator, the scalings
    associated differently)."""
    jfes, jg, tfes, tg, _, rng = kernel_problem
    monkeypatch.setenv("NEUTFEM_EQFOLD", mode)
    tg = tg["f64"]
    y = rng.standard_normal((1, *KERNEL_SHAPE))
    jgj = {n: jnp.asarray(a) for n, a in jg.items()}
    assert j_eqfold_available(jfes, jgj, y.shape, jnp.float64, "exact", interpret=True)
    assert eqfold_available(tfes, tg, y.shape, F64, "exact")
    want = j_eq_matvec(jfes, jgj, jnp.asarray(y), "exact", interpret=True)
    got = equilibrated_schur_matvec(tfes, tg, torch.tensor(y))
    sdi = torch.sqrt(tg["precond_inv"])
    classic = sdi * schur_matvec(tfes, tg, torch.tensor(y) * sdi, "exact")
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12
    assert _rel(got.numpy(), classic.numpy()) <= 1e-12


def test_eqfold_gate_declines(kernel_problem, monkeypatch):
    """The gate's declines: mode "0" or unset, a batched (Jacobi-sweep) flux,
    a_mode "diag", a context without the eq operands, RT1-P1 and a 2D mesh."""
    _, _, tfes, tg, _, _ = kernel_problem
    tg = tg["f64"]
    shape = (1, *KERNEL_SHAPE)
    monkeypatch.setenv("NEUTFEM_EQFOLD", "2")
    assert eqfold_available(tfes, tg, shape, F64, "exact")
    assert not eqfold_available(tfes, tg, (2, 1, *KERNEL_SHAPE), F64, "exact")
    assert not eqfold_available(tfes, tg, shape, F64, "diag")
    assert not eqfold_available(tfes, {k: v for k, v in tg.items()
                                       if not k.startswith("precond_eq")}, shape, F64, "exact")
    mesh3 = t_mesh.CartesianMesh.from_breaks(*[np.linspace(0.0, 3.0, 4)] * 3)
    assert not eqfold_available(t_fespace.make_fespace(mesh3, 1, 1), tg, shape, F64, "exact")
    mesh2 = t_mesh.CartesianMesh.from_breaks(np.linspace(0.0, 3.0, 4), np.linspace(0.0, 3.0, 4))
    assert not eqfold_available(t_fespace.make_fespace(mesh2, 0, 0), tg, (1, 1, 3, 3), F64,
                                "exact")
    for off in ("0", None):
        if off is None:
            monkeypatch.delenv("NEUTFEM_EQFOLD")
        else:
            monkeypatch.setenv("NEUTFEM_EQFOLD", off)
        assert not eqfold_available(tfes, tg, shape, F64, "exact")


def test_eq_wrappers_reject_what_they_do_not_take(kernel_problem):
    _, _, _, tg, coef, _ = kernel_problem
    tg = tg["f64"]
    y = torch.zeros((2, 1, *KERNEL_SHAPE), dtype=F64)
    with pytest.raises(NotImplementedError):  # a batched flux
        fused_eq.fused_schur_x_eq2(y, y, y, tg["tri_xT_dinvm_d0"], tg["tri_xT_l_d0"], *coef[0])
    y1 = torch.zeros((1, *KERNEL_SHAPE), dtype=F64)
    with pytest.raises(ValueError):  # the z operands handed to the x wrapper
        fused_eq.fused_schur_x_eq2(y1, y1, y1, tg["tri_dinvm_d2"], tg["tri_l_d2"], *coef[0])
    with pytest.raises(TypeError):  # an operand of another dtype
        fused_eq.fused_schur_z_eq2(y1, y1, y1.float(), tg["tri_dinvm_d2"], tg["tri_l_d2"],
                                   *coef[2])


@pytest.mark.parametrize("use_precond", [False, True])
def test_pcg_fused_matches_jax_on_spd_problem(use_precond):
    """krylov.pcg_fused against the JAX pcg_fused on tests/test_krylov.py's SPD
    problem (n = 120, condition 1e3) at float64.  CG runs there past n
    iterations, where the order of a dot product's sum moves the stop by a few
    iterations (port and JAX differ by 1 at condition 1e2 already, for the
    textbook pcg too), so the counts are held to tests/test_krylov.py's band
    between two CG variants (max(8, 10%)) and the solutions to its 50 tol."""
    from neutfem_tpu.krylov import pcg_fused as j_pcg_fused
    from neutfem_tpu_torch.krylov import pcg_fused

    rng = np.random.default_rng(0)
    n, tol = 120, 1e-10
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, 1e3, n)) @ Q.T
    b = rng.standard_normal(n)
    dA = np.diag(A)
    jres = j_pcg_fused(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), jnp.zeros(n),
                       precond=(lambda r: r / jnp.asarray(dA)) if use_precond else None,
                       tol=tol, maxiter=500)
    tA, tdA = torch.tensor(A), torch.tensor(dA)
    tres = pcg_fused(lambda x: tA @ x, torch.tensor(b), torch.zeros(n, dtype=F64),
                     precond=(lambda r: r / tdA) if use_precond else None, tol=tol,
                     maxiter=500)
    it_j = int(jres.iterations)
    assert abs(tres.iterations - it_j) <= max(8, 0.1 * it_j)
    x_true = np.linalg.solve(A, b)
    for x in (tres.x.numpy(), np.asarray(jres.x)):
        assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 50 * tol
    assert float(tres.residual) <= 1.5 * tol


@pytest.mark.parametrize("use_precond", [False, True])
def test_pcg_fused_matches_jax_on_equilibrated_group_system(use_precond):
    """krylov.pcg_fused against the JAX pcg_fused on one group's equilibrated
    Schur system (as tests/test_torch_solve.py holds pcg): the same iteration
    count and iterates to rel 1e-9 at float64, the solve's own tolerance (the
    Chronopoulos-Gear recurrences carry the dots' summation order further than
    the textbook loop: 1.7e-10 measured, against pcg's 1e-10 bound)."""
    from neutfem_tpu.krylov import pcg_fused as j_pcg_fused
    from neutfem_tpu.ops.apply import schur_matvec as j_schur_matvec
    from neutfem_tpu_torch.krylov import pcg_fused

    jfes, jctx, tfes, tctx, rng = _problem((6, 7, 9), seed=4, eqfold="0")
    jg = {n: jnp.asarray(a) for n, a in j_ctx_group(jctx, 0).items()}
    tg = ctx_group(tctx, 0)
    rhs = rng.standard_normal((1, 6, 7, 9))
    x0 = rng.standard_normal(rhs.shape)
    scale = rng.uniform(0.5, 2.0, rhs.shape)  # a diagonal SPD preconditioner
    jsdi, tsdi = jnp.sqrt(jg["precond_inv"]), torch.sqrt(tg["precond_inv"])
    jres = j_pcg_fused(lambda y: jsdi * j_schur_matvec(jfes, jg, y * jsdi, "exact"),
                       jnp.asarray(rhs) * jsdi, jnp.asarray(x0) / jsdi,
                       precond=(lambda r: r * jnp.asarray(scale)) if use_precond else None,
                       tol=1e-9, maxiter=500)
    tres = pcg_fused(lambda y: tsdi * schur_matvec(tfes, tg, y * tsdi, "exact"),
                     torch.tensor(rhs) * tsdi, torch.tensor(x0) / tsdi,
                     precond=(lambda r: r * torch.tensor(scale)) if use_precond else None,
                     tol=1e-9, maxiter=500)
    assert tres.iterations == int(jres.iterations) > 5
    assert _rel(tres.x.numpy(), np.asarray(jres.x)) <= 1e-9
    assert abs(float(tres.residual) - float(jres.residual)) <= 1e-10


def test_pcg_fused_zero_rhs():
    from neutfem_tpu_torch.krylov import pcg_fused

    A = torch.eye(4, dtype=F64) * 2.0
    res = pcg_fused(lambda x: A @ x, torch.zeros(4, dtype=F64), torch.ones(4, dtype=F64))
    assert res.iterations == 0 and float(res.x.abs().max()) == 0.0
    assert float(res.residual) == 0.0


@pytest.mark.parametrize("env", [{"NEUTFEM_EQFOLD": "1"}, {"NEUTFEM_EQFOLD": "2"},
                                 {"NEUTFEM_CGCG": "1"}], ids=["eqfold1", "eqfold2", "cgcg"])
def test_facade_iaea3d_switches_match_jax(monkeypatch, env):
    """IAEA-3D 1x1 RT0-P0 (19^3 cells) float64 through both facades under the
    same switch: |dk| <= 1e-9, the same outers, inners within 2 (the facade
    tests' bounds), and the port took the branch the switch selects."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"eq": 0, "cgcg": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(t_power, "equilibrated_schur_matvec",
                        spy("eq", t_power.equilibrated_schur_matvec))
    monkeypatch.setattr(t_power, "pcg_fused", spy("cgcg", t_power.pcg_fused))
    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS["iaea3d"]
    jrun = JRun(spec, mesh_n=1, mesh_nz=1)
    jrun.solve(tol=tol)
    trun = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu", dtype=F64)
    trun.solve(tol=tol)
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert trun.solver._last_outers == jrun.solver._last_outers
    assert abs(trun.solver._last_inners - jrun.solver._last_inners) <= 2
    if "NEUTFEM_EQFOLD" in env:
        assert calls["eq"] > trun.solver._last_inners and calls["cgcg"] == 0
        assert "precond_eq_sdi" in trun.solver._ctx
    else:
        assert calls["cgcg"] > 0 and calls["eq"] == 0
