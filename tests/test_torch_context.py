"""neutfem_tpu_torch.ops.context.build_context against neutfem_tpu's, key by key.

Every key the port builds must equal the JAX package's at float64 (rel <= 1e-13:
the same numpy arithmetic, float64 host factorization on both sides).  The
keys the JAX context has and the port does not build yet are named here, so a
new one on either side fails loudly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.ops.context import build_context, ctx_from_numpy

torch.set_num_threads(1)

REL = 1e-13

# JAX context keys the port does not build (none since the CMFD coupling data
# dtilde / area / jscale and sigr / vol are built too).
NOT_PORTED = set()


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale) if scale > 0 else float(np.max(np.abs(a - b)))


def _xs(shape, ng, rng):
    xs = {
        "D": rng.uniform(0.3, 2.0, (ng, *shape)),
        "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
        "NSF": rng.uniform(0.0, 0.2, (ng, *shape)),
        "Chi": np.zeros((ng, *shape)),
        "SigS": np.zeros((ng, ng, *shape)),
        "SRC": np.zeros((ng, *shape)),
    }
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.02, shape)
    return xs


def _pair(case):
    """(port ctx, JAX ctx as numpy, fes) for one boundary-condition case."""
    rng = np.random.default_rng(2)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (7, 6, 5)]
    ng = 2
    xs = _xs((5, 6, 7), ng, rng)
    kinds = {
        "dirichlet": lambda ax, up: "DIRICHLET",
        "mirror": lambda ax, up: "MIRROR" if not up else "DIRICHLET",
        "mixed": lambda ax, up: ("MIRROR", "DIRICHLET", "ROBIN")[ax] if up else "NEUMANN",
    }[case]
    tb, jb = BCSpec(), JBCSpec()
    for ax in range(3):
        for up in (False, True):
            kind = kinds(ax, up)
            tb.set(t_mesh.boundary_attribute(3, ax, up), BCKind[kind])
            jb.set(j_mesh.boundary_attribute(3, ax, up), JBCKind[kind])
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    marshak = case != "dirichlet"
    tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=torch.float64,
                         marshak_d_factor=marshak)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64,
                           marshak_d_factor=marshak)
    return tctx, {k: np.asarray(v) for k, v in jctx.items()}, tfes


def _compare(tctx, jnp_ctx):
    assert set(jnp_ctx) - set(tctx) == NOT_PORTED & set(jnp_ctx)
    assert set(tctx) <= set(jnp_ctx)
    for k, v in tctx.items():
        assert v.dtype == torch.float64 and v.is_contiguous(), k
        assert _rel(v.numpy(), jnp_ctx[k]) <= REL, k


@pytest.mark.parametrize("case", ["dirichlet", "mirror", "mixed"])
def test_context_matches_jax(case):
    tctx, jctx, _ = _pair(case)
    _compare(tctx, jctx)


def test_context_matches_jax_iaea3d_1x1():
    """The benchmark's own context (marshak_d_factor=True through the facade)."""
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    spec = BENCHMARKS["iaea3d"]
    tctx = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu",
                        dtype=torch.float64).solver._ctx
    jrun = JRun(spec, mesh_n=1, mesh_nz=1)
    jctx = {k: np.asarray(v) for k, v in jrun.solver._ctx("exact").items()}
    _compare(tctx, jctx)


def test_pinned_faces_have_zero_factors():
    """MIRROR faces: the factored off-diagonal out of the pinned face and its
    dinv*mask are exactly 0 (what the fused kernels' scalar rhs scale relies
    on), in the natural and in the staged layouts."""
    tctx, _, fes = _pair("mirror")  # MIRROR on every lower face
    for di in fes.dirs:
        key, fax = f"d{di.d}", 1 + di.axis
        mask = tctx[f"mask_{key}"]
        assert float(mask.select(di.axis, 0).abs().max()) == 0.0
        assert float(tctx[f"tri_l_{key}"].select(fax, 0).abs().max()) == 0.0
        assert float(tctx[f"tri_dinvm_{key}"].select(fax, 0).abs().max()) == 0.0
        assert float(tctx[f"tri_dinvm_{key}"].select(fax, 1).abs().min()) > 0.0
    for tag, key in (("xT", "d0"), ("yT", "d1")):  # staged: face axis leads (after ng)
        assert float(tctx[f"tri_{tag}_l_{key}"][:, 0].abs().max()) == 0.0
        assert float(tctx[f"tri_{tag}_dinvm_{key}"][:, 0].abs().max()) == 0.0


def test_ctx_from_numpy_roundtrip():
    tctx, jctx, _ = _pair("dirichlet")
    conv = ctx_from_numpy(jctx, "cpu", torch.float32)
    for k, v in conv.items():
        assert v.dtype == torch.float32 and v.is_contiguous()
        assert np.array_equal(v.numpy(), jctx[k].astype(np.float32)), k


@pytest.mark.parametrize("name,n", [("iaea3d", 1), ("zion2d", 2), ("koeberg2d", 1),
                                    ("biblis2d", 2), ("iaea2d", 2), ("zion2d", 16)])
def test_benchmark_cross_sections_match_jax_runner(name, n, monkeypatch):
    """The port's vectorized per-material fill equals the JAX runner's per-cell
    loop (ZION: baffle cells next to fuel, a baffle radius of 1 cell at 2x2
    and 3 at 16x16; KOEBERG: 4 groups, upscatter).  At 16x16 ``BuildMatrices``
    is skipped on both sides: the fill comes before it, and there the two
    builds would take ~40 s."""
    import neutfem
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch import compat
    from neutfem_tpu_torch.bench import BenchmarkRun

    if n >= 16:
        monkeypatch.setattr(neutfem.NeutFEM, "BuildMatrices", lambda self: None)
        monkeypatch.setattr(compat.NeutFEM, "BuildMatrices", lambda self: None)
    spec = BENCHMARKS[name]
    t = BenchmarkRun(spec, mesh_n=n, mesh_nz=1, device="cpu", dtype=torch.float64).solver
    j = JRun(spec, mesh_n=n, mesh_nz=1).solver
    for get in ("get_D", "get_SigR", "get_NSF", "get_Chi", "get_SigS", "get_KSF"):
        assert np.array_equal(getattr(t, get)(), getattr(j, get)()), get
