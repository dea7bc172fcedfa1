"""The port's higher-order (RT_k-P_k, k >= 1) slice against neutfem_tpu on the CPU.

* build_context for k = 1, 2 key by key at float64 (the x operands un-staged
  from the JAX package's lane-packed layout), and the float8 block
  preconditioner byte for byte at float32;
* K6 (ops/fused_ho.py) through its wrappers on CPU tensors, i.e. its plain
  version: at float32 against the JAX kernel in interpret mode (rel <= 1e-5),
  at float64 against the JAX package's unfused condensed chain (rel <= 1e-12:
  the same recurrence, different association of a few sums);
* the condensed schur_matvec, compute_current with bubbles, pcg with the
  block preconditioner and the carried JAX context;
* the NeutFEM facade on IAEA-3D 1x1 and IAEA-2D 2x2 at RT1-P1 against the JAX
  facade: |dk| <= 1e-9, identical outer counts, inners within 2 (the two
  packages sum their dot products in different orders, which can flip one CG
  stop test that sits on a tie).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.apply import _face_out, _face_rhs
from neutfem_tpu.ops.apply import schur_matvec as j_schur_matvec
from neutfem_tpu.ops.apply import solve_A_dir as j_solve_A_dir
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.ops.pallas_fused_ho import fused_ho_dir
from neutfem_tpu.power import ctx_group as j_ctx_group
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops import fused_ho
from neutfem_tpu_torch.ops.apply import J_to_public, schur_matvec
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, compute_current, ctx_group, group_solve

torch.set_num_threads(1)

F64 = torch.float64
KERNEL_SHAPE = (8, 64, 64)  # (nz, ny, nx): every JAX HO kernel engages here at float32
# JAX context keys the port does not build (none since the CMFD coupling data
# dtilde / area / jscale and sigr / vol are built too)
NOT_PORTED = set()


def _rel(got, want, base=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    base = 0.0 if base is None else np.asarray(base, dtype=np.float64)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want - base)))
    return err / scale if scale > 0 else err


def _problem(shape, k, bc="dirichlet", seed=0, jdtype=jnp.float64):
    """(JAX fes, JAX ctx as numpy, port fes, port xs, port BCSpec, rng) of one
    random 2-group RT_k-P_k problem.  bc "mirror": MIRROR on every lower face."""
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
            kind = "MIRROR" if (bc == "mirror" and not up) else "DIRICHLET"
            jb.set(j_mesh.boundary_attribute(3, ax, up), JBCKind[kind])
            tb.set(t_mesh.boundary_attribute(3, ax, up), BCKind[kind])
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), k, k)
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), k, k)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jdtype)
    return jfes, {n: np.asarray(v) for n, v in jctx.items()}, tfes, xs, tb, rng


def _unstage_x(a, shape):
    """JAX lane-packed (..., rows, nz*wy) x operand -> the port's (..., rows, nz*ny)."""
    nz, ny, _ = shape
    wy = a.shape[-1] // nz
    return a.reshape(*a.shape[:-1], nz, wy)[..., :ny].reshape(*a.shape[:-1], nz * ny)


@pytest.mark.parametrize("k,bc", [(1, "dirichlet"), (1, "mirror"), (2, "dirichlet")])
def test_context_matches_jax(k, bc):
    shape = (4, 5, 6)
    _, jctx, tfes, xs, tb, _ = _problem(shape, k, bc)
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=F64)
    assert set(jctx) - set(tctx) == NOT_PORTED
    assert set(tctx) <= set(jctx)
    for name in ("precond_inv", "precond_blk_inv", "tri_hoxT_alpha_d0", "tri_hoyT_l_d1"):
        assert name in tctx
    for name, v in tctx.items():
        want = jctx[name]
        if name.startswith("tri_hoxT_"):
            want = _unstage_x(want, shape)
        assert v.dtype == F64 and v.is_contiguous(), name
        assert _rel(v.numpy(), want) <= 1e-13, name


@pytest.mark.parametrize("k", [1, 2])
def test_block_precond_storage_matches_jax_bytes(k):
    """At float32 both packages store the equilibrated block inverse as the
    float8 e4m3 deviation E = Binv - I: the same bytes."""
    _, jctx, tfes, xs, tb, _ = _problem((4, 5, 6), k, jdtype=jnp.float32)
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32)
    assert "precond_blk_inv" not in tctx and "precond_blk_inv" not in jctx
    got = tctx["precond_blk_dev"]
    assert got.dtype == torch.float8_e4m3fn
    want = jctx["precond_blk_dev"]
    assert want.dtype.name == "float8_e4m3fn"
    assert np.array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))
    # carried across from JAX: the same bytes, dtype kept
    carried = ctx_from_numpy(jctx, "cpu", torch.float32)["precond_blk_dev"]
    assert carried.dtype == torch.float8_e4m3fn
    assert torch.equal(carried.view(torch.uint8), got.view(torch.uint8))


def test_ctx_from_numpy_keeps_bfloat16_bits():
    import ml_dtypes

    a = np.random.default_rng(1).standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16)
    got = ctx_from_numpy({"precond_blk_inv": a}, "cpu", torch.float32)["precond_blk_inv"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_mode_index_matches_fespace(k, axis):
    """The CUDA kernel's mode arithmetic (mirrored by kernel_mode_index) against
    the grouping the FE space's p -> t map gives (what the plain version uses)."""
    _, _, tfes, _, _, _ = _problem((3, 4, 5), k)
    di = [d for d in tfes.dirs if d.axis == axis][0]
    tabs = fused_ho.ho_tables(tfes, di)
    assert np.array_equal(fused_ho.kernel_mode_index(k + 1, axis), tabs.pidx)


def test_pinned_faces_have_zero_staged_factors():
    """MIRROR lower faces: l and dinv*mask are exactly 0 at the pinned face in
    every staged K6 operand (the kernel streams no mask plane)."""
    _, _, tfes, xs, tb, _ = _problem((4, 5, 6), 1, "mirror")
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=F64)
    for key in ("tri_dinvm_d2", "tri_l_d2"):
        assert float(tctx[key][:, 0].abs().max()) == 0.0
    for tag, key in (("hoyT", "d1"), ("hoxT", "d0")):
        for name in ("dinvm", "l"):
            assert float(tctx[f"tri_{tag}_{name}_{key}"][:, 0].abs().max()) == 0.0
        assert float(tctx[f"tri_{tag}_dinvm_{key}"][:, 1].abs().min()) > 0.0


@pytest.fixture(scope="module", params=[(1, "dirichlet"), (1, "mirror"), (2, "dirichlet")],
                ids=["k1-dirichlet", "k1-mirror", "k2-dirichlet"])
def kernel_problem(request):
    """Group 1 of one problem at KERNEL_SHAPE: the JAX context (float64 numpy;
    its float32 cast is what the JAX package's float32 build holds for the
    operands K6 reads) and the port's context carried across at both dtypes."""
    k, bc = request.param
    jfes, jctx, tfes, _, _, rng = _problem(KERNEL_SHAPE, k, bc, seed=5)
    jg = j_ctx_group(jctx, 1)
    tg = {prec: ctx_group(ctx_from_numpy(jctx, "cpu", tdt), 1)
          for prec, tdt in (("f32", torch.float32), ("f64", F64))}
    return jfes, jg, tfes, tg, rng


def _port_dir(tfes, tctx, axis, acc, v):
    di = [d for d in tfes.dirs if d.axis == axis][0]
    key = f"d{di.d}"
    tabs = fused_ho.ho_tables(tfes, di)
    if axis == 0:
        return fused_ho.fused_ho_z(acc, v, tctx[f"tri_dinvm_{key}"], tctx[f"tri_l_{key}"],
                                   tctx[f"alpha_{key}"], tabs)
    tag, fn = ("hoyT", fused_ho.fused_ho_y) if axis == 1 else ("hoxT", fused_ho.fused_ho_x)
    return fn(acc, v, tctx[f"tri_{tag}_dinvm_{key}"], tctx[f"tri_{tag}_l_{key}"],
              tctx[f"tri_{tag}_alpha_{key}"], tabs)


def _jax_condensed_dir(fes, cg, axis, vg):
    """The JAX package's unfused condensed contribution of one direction (the
    chain tests/test_pallas_fused_ho.py builds)."""
    di = [d for d in fes.dirs if d.axis == axis][0]
    key = f"d{di.d}"
    BXc = jnp.asarray(di.BXc, dtype=vg.dtype)
    F, _ = j_solve_A_dir(fes, di, cg[f"tri_dinv_{key}"], cg[f"tri_l_{key}"],
                         cg[f"mask_{key}"], cg[f"alpha_{key}"], _face_rhs(di, vg, BXc), None,
                         "exact")
    alpha_e = jnp.expand_dims(cg[f"alpha_{key}"], -4)
    Q = jnp.asarray(di.Qbub, dtype=vg.dtype)
    return _face_out(di, F, BXc) + jnp.einsum("...qzyx,pq->...pzyx", vg, Q) / alpha_e


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ho_kernel_plain_matches_jax_interpret_f32(kernel_problem, axis):
    jfes, jg, tfes, tg, rng = kernel_problem
    tg = tg["f32"]
    v = rng.standard_normal((1, tfes.P, *KERNEL_SHAPE)).astype(np.float32)
    acc = rng.standard_normal(v.shape).astype(np.float32)  # nonzero: must add through
    di = [d for d in jfes.dirs if d.axis == axis][0]
    key = f"d{di.d}"
    ops = {0: ("tri_dinvm", "tri_l", "alpha"), 1: ("tri_hoyT_dinvm", "tri_hoyT_l",
                                                    "tri_hoyT_alpha"),
           2: ("tri_hoxT_dinvm", "tri_hoxT_l", "tri_hoxT_alpha")}[axis]
    from neutfem_tpu.ops.pallas_fused_ho import ho_coeff_tables as j_tables

    want = fused_ho_dir(jfes, di, jnp.asarray(acc), jnp.asarray(v),
                        *(jnp.asarray(jg[f"{o}_{key}"], jnp.float32) for o in ops),
                        j_tables(jfes, di), interpret=True)
    assert want is not None, "the JAX kernel declined: the test shape no longer engages it"
    acc_t = torch.tensor(acc)
    got = _port_dir(tfes, tg, axis, acc_t, torch.tensor(v))
    assert got is acc_t  # updated in place, like the aliased TPU kernel
    assert _rel(got.numpy(), np.asarray(want), acc) <= 1e-5


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ho_kernel_plain_matches_jax_condensed_f64(kernel_problem, axis):
    jfes, jg, tfes, tg, rng = kernel_problem
    v = rng.standard_normal((1, tfes.P, *KERNEL_SHAPE))
    acc = rng.standard_normal(v.shape)
    names = [n for n in jg if n.startswith(("tri_dinv_", "tri_l_", "mask_", "alpha_"))]
    want = acc + np.asarray(jax.jit(
        lambda cg, vg: _jax_condensed_dir(jfes, cg, axis, vg))(
            {n: jnp.asarray(jg[n]) for n in names}, jnp.asarray(v)))
    got = _port_dir(tfes, tg["f64"], axis, torch.tensor(acc), torch.tensor(v))
    assert _rel(got.numpy(), want, acc) <= 1e-12


def test_ho_tables_match_jax():
    from neutfem_tpu.ops.pallas_fused_ho import ho_coeff_tables as j_tables

    for k in (1, 2):
        jfes, _, tfes, _, _, _ = _problem((3, 4, 5), k)
        for jd, td in zip(jfes.dirs, tfes.dirs):
            for a, b in zip(fused_ho.ho_coeff_tables(tfes, td), j_tables(jfes, jd)):
                assert np.array_equal(a, b)
    # m < k: the modes do not factor, no tables (the unfused chain runs)
    mesh = t_mesh.CartesianMesh.from_breaks(*[np.linspace(0, 3, 4)] * 3)
    fes = t_fespace.make_fespace(mesh, 1, 0)
    assert fused_ho.ho_coeff_tables(fes, fes.dirs[0]) is None


@pytest.fixture(scope="module")
def small_ho():
    return {k: _problem((4, 5, 6), k, "mirror", seed=3) for k in (1, 2)}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_condensed_schur_matvec_matches_jax(small_ho, k, fused):
    jfes, jctx, tfes, xs, tb, rng = small_ho[k]
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=F64)
    v = rng.standard_normal((1, tfes.P, 4, 5, 6))
    jmv = jax.jit(lambda c, x: j_schur_matvec(jfes, c, x, "exact", fused=False))
    want = jmv({n: jnp.asarray(a) for n, a in j_ctx_group(jctx, 0).items()}, jnp.asarray(v))
    got = schur_matvec(tfes, ctx_group(tctx, 0), torch.tensor(v), "exact", fused=fused)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12
    if not fused:  # all groups at once
        v2 = rng.standard_normal((2, tfes.P, 4, 5, 6))
        want = jmv({n: jnp.asarray(a) for n, a in jctx.items()}, jnp.asarray(v2))
        got = schur_matvec(tfes, tctx, torch.tensor(v2), "exact", fused=False)
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("k", [1, 2])
def test_compute_current_with_bubbles_matches_jax(small_ho, k):
    from neutfem_tpu.ops.apply import J_to_public as j_J_to_public
    from neutfem_tpu.power import compute_current as j_compute_current

    jfes, jctx, tfes, xs, tb, rng = small_ho[k]
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=F64)
    phi = rng.standard_normal((2, tfes.P, 4, 5, 6))
    want = jax.jit(lambda c, x: j_J_to_public(j_compute_current(jfes, c, x)))(
        {n: jnp.asarray(a) for n, a in jctx.items()}, jnp.asarray(phi))
    got = J_to_public(compute_current(tfes, tctx, torch.tensor(phi)))
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == {"face", "bub"}
        for part in ("face", "bub"):
            assert got[key][part].shape == want[key][part].shape
            assert _rel(got[key][part].numpy(), np.asarray(want[key][part])) <= 1e-12


def test_pcg_block_precond_matches_jax(small_ho):
    """pcg with the block preconditioner against the JAX pcg with the same one."""
    from neutfem_tpu.krylov import pcg as j_pcg
    from neutfem_tpu_torch.krylov import pcg
    from neutfem_tpu_torch.power import _block_precond

    jfes, jctx, tfes, xs, tb, rng = small_ho[1]
    tg = ctx_group(build_context(tfes, 2, xs, tb, device="cpu", dtype=F64), 0)
    jg = {n: jnp.asarray(a) for n, a in j_ctx_group(jctx, 0).items()}
    rhs = rng.standard_normal((tfes.P, 4, 5, 6))
    x0 = rng.standard_normal(rhs.shape)
    jsdi, tsdi = jnp.sqrt(jg["precond_inv"]), torch.sqrt(tg["precond_inv"])
    bi = jg["precond_blk_inv"]
    jres = j_pcg(lambda y: jsdi * j_schur_matvec(jfes, jg, y * jsdi, "exact"),
                 jnp.asarray(rhs) * jsdi, jnp.asarray(x0) / jsdi,
                 precond=lambda r: jnp.einsum("...pqabc,...qabc->...pabc", bi, r),
                 tol=1e-10, maxiter=500)
    tres = pcg(lambda y: tsdi * schur_matvec(tfes, tg, y * tsdi, "exact"),
               torch.tensor(rhs) * tsdi, torch.tensor(x0) / tsdi,
               precond=_block_precond(tg, F64), tol=1e-10, maxiter=500)
    assert tres.iterations == int(jres.iterations) > 5
    assert float(torch.max(torch.abs(tres.x - torch.tensor(np.asarray(jres.x))))) <= 1e-12


def test_carried_jax_context_matches_port_context():
    """The JAX context of a k = 1 problem at float32 (lane-packed x operands,
    float8 block preconditioner) carried across by ctx_from_numpy gives the
    port's own schur_matvec and the same group_solve iterations."""
    _, jctx, tfes, xs, tb, rng = _problem((4, 5, 6), 1, "mirror", seed=7, jdtype=jnp.float32)
    own = ctx_group(build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32), 0)
    carried = ctx_group(ctx_from_numpy(jctx, "cpu", torch.float32), 0)
    assert set(own) <= set(carried)
    v = torch.tensor(rng.standard_normal((1, tfes.P, 4, 5, 6)), dtype=torch.float32)
    assert torch.equal(schur_matvec(tfes, own, v), schur_matvec(tfes, carried, v))
    rhs = torch.tensor(rng.standard_normal((tfes.P, 4, 5, 6)), dtype=torch.float32)
    opts = SolveOptions(inner_tol=1e-5)
    r_own = group_solve(tfes, own, opts, rhs, torch.zeros_like(rhs))
    r_car = group_solve(tfes, carried, opts, rhs, torch.zeros_like(rhs))
    assert r_own.iterations == r_car.iterations > 3
    assert torch.equal(r_own.x, r_car.x)


def test_rt0_counts_unchanged():
    """The identity-preconditioner pcg keeps the RT0-P0 IAEA-3D 1x1 float64
    counts of the JAX package (49 outers, 275 inners) exactly."""
    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS

    run = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cpu",
                       dtype=F64)
    run.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
    assert (run.solver._last_outers, run.solver._last_inners) == (49, 275)


@pytest.mark.parametrize("name,n,anchor", [("iaea3d", 1, (1.0286842, 49, 373)),
                                           ("iaea2d", 2, None)])
def test_facade_rt1p1_matches_jax(name, n, anchor):
    """IAEA-3D 1x1 (19^3 cells, K6 plain version) and IAEA-2D 2x2 (the unfused
    condensed chain, 2D) at RT1-P1 through both NeutFEM facades."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS[name]
    jrun = JRun(spec, mesh_n=n, mesh_nz=1, rt_order=1)
    jrun.solve(tol=tol)
    trun = BenchmarkRun(spec, mesh_n=n, mesh_nz=1, device="cpu", dtype=F64, rt_order=1)
    trun.solve(tol=tol)
    t, j = trun.solver, jrun.solver
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert t._last_outers == j._last_outers
    assert abs(t._last_inners - j._last_inners) <= 2
    if anchor is not None:
        assert trun.keff == pytest.approx(anchor[0], abs=5e-8)
        assert t._last_outers == anchor[1]
        assert abs(t._last_inners - anchor[2]) <= 2
    assert _rel(t._phi.numpy(), np.asarray(j._phi)) <= 1e-7


def test_ho_tables_are_dropped_with_their_direction():
    """K6's coefficient tables, and their copies on the device, are kept per
    direction object and dropped when the direction is freed: a process that
    rebuilds its solver does not keep every old fespace's tables."""
    import gc

    fes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*[np.linspace(0, 2, 3)] * 3),
                                 1, 1)
    keys = {id(di) for di in fes.dirs}
    tables = [fused_ho.ho_tables(fes, di) for di in fes.dirs]
    assert all(t is not None for t in tables) and keys <= set(fused_ho._TABLES)
    fused_ho._device_table(tables[0], torch.float64, torch.device("cpu"))
    tkey = id(tables[0])
    assert any(k[0] == tkey for k in fused_ho._DEVICE_TABLES)
    del fes, tables
    gc.collect()
    assert not keys & set(fused_ho._TABLES)
    assert not any(k[0] == tkey for k in fused_ho._DEVICE_TABLES)
