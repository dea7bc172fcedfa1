"""The fused block-Jacobi apply + CG dots (K8, ``NEUTFEM_BLOCKJAC``) and the
``NEUTFEM_BLKFP8`` storage switch of neutfem_tpu_torch against the JAX package.

* ``blockjac_dots`` (``ops/blockjac.py``; on a CPU tensor its plain version)
  against the JAX Pallas kernel run in interpret mode, at P = 8 and P = 27
  with float32 and bfloat16 blocks, at shapes the JAX gate takes (rows >= 512,
  nx >= 64);
* the block inverse under ``NEUTFEM_BLKFP8=0``: bfloat16, the same bytes as
  the JAX package's;
* ``pcg(precond_dots=...)`` against ``pcg(precond=...)``, and
  ``group_solve``'s K8 branch and its declines;
* IAEA-3D 1x1 RT1-P1 float32 through both facades under ``NEUTFEM_BLKFP8=0
  NEUTFEM_BLOCKJAC=1`` (on a CPU the JAX package runs its einsum apply: no
  Pallas backend).

Tolerances are written beside each assertion.  The kernel itself is compared
with the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import config as j_config
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.ops.pallas_blockjac import blockjac_dots as j_blockjac_dots
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch import power as t_power
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.krylov import pcg
from neutfem_tpu_torch.ops.blockjac import blockjac_dots
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_solve

torch.set_num_threads(1)


def _bf16_bits(a):
    """A JAX bfloat16 array as a torch bfloat16 tensor with the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("P,shape", [(8, (2, 256, 70)), (27, (1, 512, 64))])
@pytest.mark.parametrize("bi_dtype", ["float32", "bfloat16"])
def test_plain_blockjac_matches_jax_interpret(P, shape, bi_dtype):
    """z within 2e-5 (float32 blocks) / 2e-2 (bf16 blocks) and the dots within
    rel 2e-3: tests/test_pallas_blockjac.py's tolerances (the dots are
    near-cancelling sums of ~10^5-10^6 float32 terms summed in another order)."""
    rng = np.random.default_rng(7)
    jbi = jnp.asarray(rng.standard_normal((P, P, *shape), dtype=np.float32),
                      getattr(jnp, bi_dtype))
    r = rng.standard_normal((1, P, *shape), dtype=np.float32)
    out = j_blockjac_dots(jbi, jnp.asarray(r), interpret=True)
    assert out is not None, "the JAX kernel declined: the test shape no longer engages it"
    bi = _bf16_bits(jbi) if bi_dtype == "bfloat16" else torch.from_numpy(np.array(jbi))
    z, rz, rr = blockjac_dots(bi, torch.from_numpy(r))
    tol = 2e-2 if bi_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(z.numpy(), np.asarray(out[0]), rtol=tol, atol=tol)
    assert z.shape == r.shape and z.dtype == torch.float32 and z.is_contiguous()
    np.testing.assert_allclose(float(rz), float(out[1]), rtol=2e-3)
    np.testing.assert_allclose(float(rr), float(out[2]), rtol=2e-3)


def test_blockjac_rejects_what_it_does_not_take():
    bi = torch.zeros((8, 8, 2, 3, 4))
    with pytest.raises(ValueError):  # a batched (2, P, ...) residual
        blockjac_dots(bi, torch.zeros((2, 8, 2, 3, 4)))
    with pytest.raises(ValueError):  # spatial shapes that disagree
        blockjac_dots(bi, torch.zeros((8, 2, 3, 5)))
    with pytest.raises(ValueError):  # not (P, P, ...)
        blockjac_dots(torch.zeros((8, 4, 2, 3, 4)), torch.zeros((8, 2, 3, 4)))


def _problem(shape, k, seed=0):
    """(JAX fes, port fes, xs, JAX BCSpec, port BCSpec, rng) of one random
    2-group RT_k-P_k problem (MIRROR lower faces, Marshak upper)."""
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
    return jfes, tfes, xs, jb, tb, rng


@pytest.mark.parametrize("k", [1, 2])
def test_block_precond_bf16_storage_matches_jax_bytes(monkeypatch, k):
    """Under NEUTFEM_BLKFP8=0 both packages store the float32 equilibrated block
    inverse as bfloat16 ``precond_blk_inv`` (no fp8 deviation): the same bytes;
    ctx_from_numpy carries JAX's across bit for bit."""
    monkeypatch.setenv("NEUTFEM_BLKFP8", "0")
    jfes, tfes, xs, jb, tb, _ = _problem((4, 5, 6), k)
    jctx = j_build_context(jfes, 2, xs, jb, a_mode="exact", dtype=jnp.float32)
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32)
    assert "precond_blk_dev" not in tctx and "precond_blk_dev" not in jctx
    got, want = tctx["precond_blk_inv"], np.asarray(jctx["precond_blk_inv"])
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    carried = ctx_from_numpy({"precond_blk_inv": want}, "cpu", torch.float32)
    assert torch.equal(carried["precond_blk_inv"].view(torch.int16), got.view(torch.int16))
    monkeypatch.setenv("NEUTFEM_BLKFP8", "1")  # the default: the fp8 deviation
    tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32)
    assert "precond_blk_inv" not in tctx and tctx["precond_blk_dev"].dtype == torch.float8_e4m3fn


def test_pcg_precond_dots_matches_precond():
    """pcg(precond_dots=...) gives pcg(precond=...)'s iterates (to 1e-12, float64)
    and iteration count when the fused callable returns the same (z, rz, rr)."""
    rng = np.random.default_rng(11)
    n = 64
    A = rng.standard_normal((n, n))
    A = torch.tensor(A @ A.T + n * np.eye(n))
    b = torch.tensor(rng.standard_normal(n))
    minv = 1.0 / torch.diag(A)
    calls = []

    def pc_dots(r):
        calls.append(1)
        z = minv * r
        return z, torch.sum(r * z), torch.sum(r * r)

    a = pcg(lambda x: A @ x, b, torch.zeros(n, dtype=torch.float64), precond=lambda r: minv * r,
            tol=1e-12, maxiter=300)
    c = pcg(lambda x: A @ x, b, torch.zeros(n, dtype=torch.float64), precond_dots=pc_dots,
            tol=1e-12, maxiter=300)
    assert a.iterations == c.iterations > 5
    assert len(calls) == c.iterations + 1  # r0, then once per iteration
    assert float(torch.max(torch.abs(a.x - c.x))) <= 1e-12 * float(torch.max(torch.abs(a.x)))


@pytest.fixture(scope="module")
def rt1_f32():
    """One group of a float32 RT1-P1 problem with bf16 block storage
    (NEUTFEM_BLKFP8=0), and a right-hand side."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUTFEM_BLKFP8", "0")
        _, tfes, xs, _, tb, rng = _problem((4, 5, 6), 1, seed=3)
        tctx = build_context(tfes, 2, xs, tb, device="cpu", dtype=torch.float32)
    rhs = torch.tensor(rng.standard_normal((tfes.P, 4, 5, 6)), dtype=torch.float32)
    return tfes, ctx_group(tctx, 0), rhs


def _spy(monkeypatch):
    calls = []
    real = t_power.blockjac_dots

    def wrapped(bi, r):
        calls.append(1)
        return real(bi, r)

    monkeypatch.setattr(t_power, "blockjac_dots", wrapped)
    return calls


def test_group_solve_takes_k8_under_blockjac(rt1_f32, monkeypatch):
    """NEUTFEM_BLOCKJAC=1 on bf16 blocks: group_solve runs the fused apply +
    dots once per CG iteration (and at r0), with the default apply's
    iteration count and solution (rel 1e-5, float32: the same products summed
    by einsum instead of bmm)."""
    tfes, tg, rhs = rt1_f32
    opts = SolveOptions(inner_tol=1e-5)
    calls = _spy(monkeypatch)
    ref = group_solve(tfes, tg, opts, rhs, torch.zeros_like(rhs))
    assert not calls
    monkeypatch.setenv("NEUTFEM_BLOCKJAC", "1")
    got = group_solve(tfes, tg, opts, rhs, torch.zeros_like(rhs))
    assert got.iterations == ref.iterations > 3
    assert len(calls) == got.iterations + 1
    assert float(torch.max(torch.abs(got.x - ref.x))) <= 1e-5 * float(torch.max(torch.abs(ref.x)))


def test_group_solve_k8_declines(rt1_f32, monkeypatch):
    """K8 engages only with pcg (not under NEUTFEM_CGCG=1), for float32 r, on
    one group's precond_blk_inv (not the fp8 deviation, not the Jacobi sweep's
    batched solve)."""
    tfes, tg, rhs = rt1_f32
    opts = SolveOptions(inner_tol=1e-5)
    calls = _spy(monkeypatch)
    monkeypatch.setenv("NEUTFEM_BLOCKJAC", "1")
    monkeypatch.setenv("NEUTFEM_CGCG", "1")
    group_solve(tfes, tg, opts, rhs, torch.zeros_like(rhs))
    monkeypatch.delenv("NEUTFEM_CGCG")
    tg64 = {k: (v.double() if v.is_floating_point() and v.dtype != torch.bfloat16 else v)
            for k, v in tg.items() if not isinstance(v, dict)}
    group_solve(tfes, tg64, opts, rhs.double(), torch.zeros_like(rhs.double()))
    fp8 = dict(tg)
    bi = fp8.pop("precond_blk_inv")
    eye = torch.eye(tfes.P).reshape(tfes.P, tfes.P, 1, 1, 1)
    fp8["precond_blk_dev"] = (bi.float() - eye).to(torch.float8_e4m3fn)
    group_solve(tfes, fp8, opts, rhs, torch.zeros_like(rhs))
    batched = {k: (v.unsqueeze(0).expand(2, *v.shape).contiguous()
                   if k.startswith(("C", "alpha_", "tri_", "precond")) else v)
               for k, v in tg.items()}
    group_solve(tfes, batched, opts, rhs.expand(2, *rhs.shape).contiguous(),
                torch.zeros((2, *rhs.shape)))
    assert not calls


def test_facade_rt1p1_blockjac_matches_jax(monkeypatch):
    """IAEA-3D 1x1 RT1-P1 float32 under NEUTFEM_BLKFP8=0 NEUTFEM_BLOCKJAC=1
    through both facades (the JAX package switched to float32 for the test).
    Measured on a CPU: both 49 outers and 368 inners, k 1.02868330 (JAX) and
    1.02868378 (port), 4.8e-7 apart — float32 rounding of two
    implementations (the 8x8x8 float32 row shows 1e-5 of it at larger
    meshes); held to |dk| <= 2e-6, the same outers and inners within 2; the
    port's K8 branch ran every CG iteration."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    monkeypatch.setenv("NEUTFEM_BLKFP8", "0")
    monkeypatch.setenv("NEUTFEM_BLOCKJAC", "1")
    calls = _spy(monkeypatch)
    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS["iaea3d"]
    x64 = j_config.x64_enabled()
    j_config.set_x64(False)
    try:
        jrun = JRun(spec, mesh_n=1, mesh_nz=1, rt_order=1)
        jrun.solve(tol=tol)
        j_outers, j_inners = jrun.solver._last_outers, jrun.solver._last_inners
        assert jnp.dtype(jrun.solver._dtype) == jnp.float32
    finally:
        j_config.set_x64(x64)
    trun = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu", dtype=torch.float32,
                        rt_order=1)
    trun.solve(tol=tol)
    s = trun.solver
    assert s._ctx["precond_blk_inv"].dtype == torch.bfloat16
    assert abs(trun.keff - jrun.keff) <= 2e-6
    assert s._last_outers == j_outers
    assert abs(s._last_inners - j_inners) <= 2
    assert len(calls) > s._last_inners
