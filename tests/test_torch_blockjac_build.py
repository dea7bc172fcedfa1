"""The block-Jacobi build of neutfem_tpu_torch (``ops/context._block_precond``)
against the numpy build it replaced, on the CPU.

The context's P x P block inverse is built on the context's device in
float64 from the host's ingredients (``build_host_context``: the stacked
coefficients, the per-cell fields, C and the exact Schur diagonal).  The
plain reference (``tests/blockjac_reference.py``) is the former host build.

* float64: the inverse within 1e-12 of the largest entry (LU on another
  library; the blocks are equilibrated to unit diagonal) at RT1-P1 and
  RT2-P2 on IAEA-3D 1x1x1 (19^3 cells);
* float32: the fp8 E-form and, under ``NEUTFEM_BLKFP8=0``, the bfloat16
  inverse are the reference's bytes, but where both are rounding noise of
  an exact zero (``blockjac_reference.assert_same_storage``);
* the storage decision on both sides of 440, from a block planted with a
  chosen max|Binv - I|, and a singular block raises;
* ``context.blockjac_blocks`` counts the blocks inverted.
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as dc
from blockjac_reference import (assert_same_storage, reference_emax, reference_inverse,
                                reference_store)
from neutfem_tpu_torch import tracing
from neutfem_tpu_torch.bench import BenchmarkRun
from neutfem_tpu_torch.data import BENCHMARKS
from neutfem_tpu_torch.ops.context import build_context, build_host_context, context_to_device

F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module", params=[1, 2], ids=["rt1p1", "rt2p2"])
def iaea(request):
    """IAEA-3D 1x1x1 (19^3 cells) at RT1-P1 / RT2-P2, float64 on the CPU:
    the facade, its host context and the reference inverse."""
    run = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cpu", dtype=F64,
                       rt_order=request.param)
    s = run.solver
    fes = s._fes
    host = build_host_context(fes, s._ng, s._xs, s._bcs, marshak_d_factor=True)
    ref, fp8 = reference_inverse(host[1], fes.P, fes.mesh.shape)
    return s, host, ref, fp8


def test_float64_inverse_matches_the_numpy_build(iaea):
    s, host, ref, _ = iaea
    assert host[1]["fields"].shape[2:] == s._fes.mesh.shape == (19, 19, 19)
    for got in (s._ctx["precond_blk_inv"],
                context_to_device(*host, s._fes.P, "cpu", F64)["precond_blk_inv"]):
        assert got.dtype == F64 and got.shape == ref.shape
        assert float(np.max(np.abs(got.numpy() - ref))) <= 1e-12 * float(np.max(np.abs(ref)))


@pytest.mark.parametrize("blkfp8", ["1", "0"])
def test_float32_storage_is_the_numpy_builds_bytes(iaea, monkeypatch, blkfp8):
    s, host, ref, fp8 = iaea
    monkeypatch.setenv("NEUTFEM_BLKFP8", blkfp8)
    got = {k: v for k, v in context_to_device(*host, s._fes.P, "cpu", F32).items()
           if k.startswith("precond_blk")}
    want = reference_store(ref, fp8, s._fes.P, F32, blkfp8)
    assert fp8  # IAEA-3D's blocks sit far from e4m3's saturation
    assert list(got) == list(want) == ["precond_blk_dev" if blkfp8 == "1" else "precond_blk_inv"]
    assert_same_storage(next(iter(got.values())), next(iter(want.values())))


@pytest.mark.parametrize("emax", [439.9, 440.1])
def test_fp8_decision_on_both_sides_of_440(emax):
    fes, ng, xs, bcs = dc.port_problem(dc.core3d(4, 5, 6, k=1))
    ctx_np, blk = build_host_context(fes, ng, xs, bcs)
    planted = dc.plant_block(blk, 37, emax)
    ref, fp8 = reference_inverse(planted, fes.P, fes.mesh.shape)
    assert reference_emax(reference_inverse(blk, fes.P, fes.mesh.shape)[0]) < 10.0
    assert abs(reference_emax(ref) - emax) < 1e-3 and fp8 == (emax < 440.0)
    got = context_to_device(ctx_np, planted, fes.P, "cpu", F32)
    want = reference_store(ref, fp8, fes.P, F32)
    key = "precond_blk_dev" if fp8 else "precond_blk_inv"
    assert key in got and set(got).isdisjoint({"precond_blk_dev", "precond_blk_inv"} - {key})
    assert_same_storage(got[key], want[key])


def test_singular_block_raises():
    fes, ng, xs, bcs = dc.port_problem(dc.core3d(4, 5, 6, k=1))
    ctx_np, blk = build_host_context(fes, ng, xs, bcs)
    bad = dc.plant_block(blk, 5, 440.0)
    bad["coefs"][:, -1] = -np.eye(fes.P).reshape(-1)  # the planted block: I - I
    with pytest.raises(torch.linalg.LinAlgError, match=f"{ng} singular"):
        context_to_device(ctx_np, bad, fes.P, "cpu", F64)


@pytest.mark.parametrize("k", [0, 1])
def test_blockjac_blocks_counter(k):
    fes, ng, xs, bcs = dc.port_problem(dc.core3d(4, 5, 6, k=k))
    with tracing.collect() as c:
        ctx = build_context(fes, ng, xs, bcs, "cpu", F64)
    blocks = c.record["counters"].get("context.blockjac_blocks", 0)
    assert blocks == (ng * 4 * 5 * 6 if k else 0)
    assert ("precond_blk_inv" in ctx) == bool(k)
    assert ("neutfem.context.blockjac" in c.record["spans"]) == bool(k)
