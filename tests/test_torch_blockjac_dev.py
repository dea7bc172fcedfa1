"""The default float32 block preconditioner — the fp8 E-form, z = r + E r with
E = B^-1 - I stored as float8 e4m3 — through the K8 entry ``blockjac_dev_dots``
of neutfem_tpu_torch, against the JAX package.

* the E-form plain version (``blockjac_dots_plain(..., deviation=True)``, what
  the wrapper runs on a CPU tensor) against the JAX package's apply, ``r +
  einsum(dev.astype(bfloat16), r)`` (``neutfem_tpu/power.py:279``), on the
  same fp8 bytes made from a numpy seed, at P = 8, 27 and 5 on a cell count
  no multiple of the kernel's tile; the dots against float64 sums;
* ``group_solve``'s route: one group's float32 pcg on ``precond_blk_dev``
  takes the E-form entry once per CG iteration (and at r0), with the
  ``_block_precond`` apply's iteration count; float64, the Jacobi sweep's
  batched solve and ``NEUTFEM_CGCG=1`` keep ``_block_precond``;
* IAEA-3D 1x1 RT1-P1 float32 with the default block storage through both
  facades: the route taken every CG iteration, k and the counts against the
  JAX package's.

Tolerances are written beside each assertion.  The kernel itself is compared
with the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import config as j_config
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch import power as t_power
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops.blockjac import blockjac_dev_dots
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import SolveOptions, _block_precond, ctx_group, group_solve

torch.set_num_threads(1)


def _fp8_pair(values):
    """The same e4m3 bytes as a JAX float8_e4m3fn array and a torch tensor."""
    j = jnp.asarray(values, jnp.float32).astype(jnp.float8_e4m3fn)
    bits = np.asarray(j).view(np.uint8).copy()
    return j, torch.from_numpy(bits).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("P", [8, 27, 5])
def test_eform_plain_matches_jax(P):
    """z against JAX's apply within rel 1e-5 of the deviation part E r (both
    widen the same e4m3 bytes exactly and sum P float32 products; the
    kernel's tolerance, chip_smoke.py's KERNEL_REL_TOL); <r, z> and <r, r>
    against float64 sums of the same widened entries within rel 1e-5.
    (3, 7, 11): 231 cells, no multiple of 16 nor of the kernel's tile."""
    shape = (3, 7, 11)
    rng = np.random.default_rng(100 + P)
    jdev, dev = _fp8_pair(0.3 * rng.standard_normal((P, P, *shape)))
    r = rng.standard_normal((P, *shape)).astype(np.float32)
    jr = jnp.asarray(r)
    want = np.asarray(jr + jnp.einsum("...pqabc,...qabc->...pabc",
                                      jdev.astype(jnp.bfloat16), jr))
    z, rz, rr = blockjac_dev_dots(dev, torch.from_numpy(r))
    assert z.shape == r.shape and z.dtype == torch.float32 and z.is_contiguous()
    err = np.max(np.abs(z.numpy() - want))
    assert err <= 1e-5 * np.max(np.abs(want - r))
    e64 = dev.to(torch.float64).numpy().reshape(P, P, -1)
    r64 = r.astype(np.float64).reshape(P, -1)
    z64 = r64 + np.einsum("pqc,qc->pc", e64, r64)
    np.testing.assert_allclose(float(rz), np.sum(r64 * z64), rtol=1e-5)
    np.testing.assert_allclose(float(rr), np.sum(r64 * r64), rtol=1e-5)


def test_eform_rejects_what_it_does_not_take():
    dev = torch.zeros((8, 8, 2, 3, 4), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError):  # a batched (2, P, ...) residual
        blockjac_dev_dots(dev, torch.zeros((2, 8, 2, 3, 4)))
    with pytest.raises(ValueError):  # spatial shapes that disagree
        blockjac_dev_dots(dev, torch.zeros((8, 2, 3, 5)))
    with pytest.raises(ValueError):  # not (P, P, ...)
        blockjac_dev_dots(dev[:, :4], torch.zeros((8, 2, 3, 4)))


def _rt1_group(seed=3):
    """(fes, one group's float32 context with the default fp8 E-form blocks,
    rhs) of a random 2-group RT1-P1 problem on a (4, 5, 6) mesh."""
    rng = np.random.default_rng(seed)
    shape = (4, 5, 6)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in shape[::-1]]
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(3):
        for up in (False, True):
            bcs.set(t_mesh.boundary_attribute(3, ax, up),
                    BCKind.DIRICHLET if up else BCKind.MIRROR)
    fes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 1, 1)
    ctx = build_context(fes, ng, xs, bcs, device="cpu", dtype=torch.float32)
    assert ctx["precond_blk_dev"].dtype == torch.float8_e4m3fn
    rhs = torch.tensor(rng.standard_normal((fes.P, *shape)), dtype=torch.float32)
    return fes, ctx, rhs


@pytest.fixture(scope="module")
def rt1_f32():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NEUTFEM_BLKFP8", raising=False)
        return _rt1_group()


def _spy(monkeypatch):
    calls = []
    real = t_power.blockjac_dev_dots

    def wrapped(dev, r):
        calls.append(1)
        return real(dev, r)

    monkeypatch.setattr(t_power, "blockjac_dev_dots", wrapped)
    return calls


def test_group_solve_takes_the_eform_entry(rt1_f32, monkeypatch):
    """One group's float32 pcg on the E-form runs blockjac_dev_dots at r0 and
    once per CG iteration, with the iteration count of the _block_precond
    apply (torch.bmm on the float32 copy) and its solution within rel 1e-5
    (float32: the same products summed in another order)."""
    fes, ctx, rhs = rt1_f32
    tg = ctx_group(ctx, 0)
    opts = SolveOptions(inner_tol=1e-5)
    calls = _spy(monkeypatch)
    got = group_solve(fes, tg, opts, rhs, torch.zeros_like(rhs))
    assert len(calls) == got.iterations + 1 and got.iterations > 3
    sdi = torch.sqrt(tg["precond_inv"])
    ref = t_power.pcg(lambda y: sdi * t_power.schur_matvec(fes, tg, y * sdi), rhs * sdi,
                      torch.zeros_like(rhs), precond=_block_precond(tg, torch.float32),
                      tol=1e-5, maxiter=opts.max_inner)
    assert got.iterations == ref.iterations
    x_ref = ref.x * sdi
    assert float(torch.max(torch.abs(got.x - x_ref))) <= 1e-5 * float(torch.max(torch.abs(x_ref)))


def test_group_solve_eform_declines(rt1_f32, monkeypatch):
    """The E-form entry serves pcg on one group's float32 flux only: not
    under NEUTFEM_CGCG=1 (pcg_fused), not at float64, not for the Jacobi
    sweep's batched (ng, ...) solve — those keep _block_precond."""
    fes, ctx, rhs = rt1_f32
    tg = ctx_group(ctx, 0)
    opts = SolveOptions(inner_tol=1e-5)
    calls = _spy(monkeypatch)
    monkeypatch.setenv("NEUTFEM_CGCG", "1")
    group_solve(fes, tg, opts, rhs, torch.zeros_like(rhs))
    monkeypatch.delenv("NEUTFEM_CGCG")
    tg64 = {k: (v.double() if v.is_floating_point() and v.element_size() > 1 else v)
            for k, v in tg.items() if not isinstance(v, dict)}
    group_solve(fes, tg64, opts, rhs.double(), torch.zeros_like(rhs.double()))
    res = group_solve(fes, ctx, opts, torch.stack([rhs, rhs]), torch.zeros((2, *rhs.shape)))
    assert res.iterations > 3
    assert not calls


@pytest.fixture(scope="module")
def facades_f32():
    """IAEA-3D 1x1 RT1-P1 float32, default block storage, through both
    facades: (JAX k, outers, inners), (port k, outers, inners, E-form calls,
    stored block dtype)."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    spec = BENCHMARKS["iaea3d"]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NEUTFEM_BLKFP8", raising=False)
        mp.delenv("NEUTFEM_BLOCKJAC", raising=False)
        calls = _spy(mp)
        x64 = j_config.x64_enabled()
        j_config.set_x64(False)
        try:
            jrun = JRun(spec, mesh_n=1, mesh_nz=1, rt_order=1)
            jrun.solve(tol=tol)
            assert jnp.dtype(jrun.solver._dtype) == jnp.float32
            jax_out = (jrun.keff, jrun.solver._last_outers, jrun.solver._last_inners)
        finally:
            j_config.set_x64(x64)
        trun = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu", dtype=torch.float32,
                            rt_order=1)
        trun.solve(tol=tol)
        s = trun.solver
        port_out = (trun.keff, s._last_outers, s._last_inners, len(calls),
                    s._ctx["precond_blk_dev"].dtype)
    return jax_out, port_out


def test_facade_rt1p1_f32_takes_the_eform_entry(facades_f32):
    """The default float32 RT1-P1 solve stores the fp8 E-form and applies it
    through blockjac_dev_dots at least once per CG iteration."""
    _, (_, outers, inners, calls, dtype) = facades_f32
    assert dtype == torch.float8_e4m3fn
    assert calls >= inners > 0


def test_facade_rt1p1_f32_matches_jax(facades_f32):
    """k within 1e-6 of the JAX package's float32 solve on the same inputs,
    the same outer count, inners within 2.  Measured on a CPU: JAX k
    1.02868366, 49 outers, 368 inners; the port 1.02868402, 49 outers, 368
    inners (3.6e-7 apart: float32 rounding of two implementations)."""
    (jk, jo, ji), (tk, to, ti, _, _) = facades_f32
    assert abs(tk - jk) <= 1e-6
    assert to == jo
    assert abs(ti - ji) <= 2
