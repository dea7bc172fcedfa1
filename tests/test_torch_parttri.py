"""The port's partitioned cut-axis solve (``neutfem_tpu_torch/ops/parttri.py``)
against the JAX package's, float64 on the CPU (``tests/test_parttri.py``'s
cases):

* ``build_partitioned``: the same bundle as the JAX function, free and pinned
  faces, the group-batched layout, p = 1, and the same declines;
* the rank-level solve on 4 gloo ranks (spawned, ``torch_dist_cases``)
  against the JAX package's global solve;
* ``partitioned_schur_dir`` (4 ranks, z cut) against the port's own unfused
  chain (``_face_rhs`` -> ``solve_A_dir`` -> ``_face_out``) to 1e-12 at RT0
  (``BX[:2]``) and condensed RT1 (``BXc``), on both groups at once (the
  Jacobi sweep's group-batched bundle) and under the diagonal A (the
  elementwise cut solve), with the partitioned path's application count; and, as the reference side, the JAX function on the
  8-device virtual mesh of ``tests/conftest.py`` against the JAX unfused
  chain, with its ``_segments_solve`` calls counted.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_cases as dc
from neutfem_tpu.ops import parttri as j_parttri
from neutfem_tpu.ops.tridiag import _scan_solve, tridiag_factor
from neutfem_tpu_torch.ops import parttri

P_RANKS = 4


def _system(rng, batch, m, fax, pinned=()):
    """Random SPD tridiagonal batch, face axis ``fax``, with ``pinned`` faces
    factored the way the context pins them (diag 1, couplings 0)."""
    a = rng.uniform(2.5, 4.0, size=batch[:fax] + (m,) + batch[fax:])
    b = rng.uniform(-1.0, -0.2, size=batch[:fax] + (m - 1,) + batch[fax:])
    for f in pinned:
        a[:, f] = 1.0
        b[:, f - 1] = 0.0
        if f < m - 1:
            b[:, f] = 0.0
    dinv, l = tridiag_factor(jnp.asarray(a), jnp.asarray(b), axis=fax)
    return np.asarray(dinv), np.asarray(l)


#: name -> (batch, faces, parts, pinned faces, rhs T)
SYSTEMS = {
    "free": ((2, 5, 8), 2 * P_RANKS + 1, P_RANKS, (), 3),
    "pinned": ((2, 5, 8), 2 * P_RANKS + 1, P_RANKS, (P_RANKS, 3), 3),
    "batched": ((2, 4, 8), 3 * P_RANKS + 1, P_RANKS, (), 2),
    "p1": ((2, 4, 8), 13, 1, (), 1),
}


def _factors(name):
    batch, m, p, pinned, _ = SYSTEMS[name]
    rng = np.random.default_rng(sorted(SYSTEMS).index(name))
    return _system(rng, batch, m, 1, pinned)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_build_partitioned_matches_jax(name):
    dinv, l = _factors(name)
    p = SYSTEMS[name][2]
    got = parttri.build_partitioned(dinv, l, 1, p)
    want = j_parttri.build_partitioned(dinv, l, 1, p)
    assert set(got) == set(want) == set(parttri.PART_NAMES)
    assert got["minv"].shape[-2:] == (2 * p, 2 * p)
    for nm in parttri.PART_NAMES:
        assert got[nm].shape == want[nm].shape, nm
        np.testing.assert_allclose(got[nm], want[nm], rtol=0, atol=1e-14, err_msg=nm)


def test_build_partitioned_declines_as_jax():
    rng = np.random.default_rng(1)
    for m, p in ((14, 8), (9, 8), (3, 2)):  # 13 % 8; one face a segment (twice)
        dinv, l = _system(rng, (1, 4, 4), m, 1)
        assert parttri.build_partitioned(dinv, l, 1, p) is None
        assert j_parttri.build_partitioned(dinv, l, 1, p) is None


def _global_solve(dinv, l, rhs):
    """The JAX package's global solve along the face axis 2 of rhs."""
    d = jnp.expand_dims(jnp.asarray(dinv), 1)
    ll = jnp.expand_dims(jnp.asarray(l), 1)
    n = rhs.shape[2]
    d_b = jnp.broadcast_to(d, rhs.shape)
    l_b = jnp.broadcast_to(ll, rhs.shape[:2] + (n - 1,) + rhs.shape[3:])
    return np.asarray(_scan_solve(jnp.asarray(rhs), d_b, l_b, 2))


def _rhs(name):
    batch, m, _, _, T = SYSTEMS[name]
    rng = np.random.default_rng(100 + sorted(SYSTEMS).index(name))
    return rng.normal(size=(batch[0], T, m, *batch[1:]))


#: the 4-rank solves (p = 1 runs on one rank of its own world below)
SOLVES = ("free", "pinned", "batched")


def _schur_data():
    """name -> (data, v, the case's options): RT0 and condensed RT1 on one
    group, RT0 on both groups at once with the context not group-sliced (the
    Jacobi sweep's group-batched bundle), and RT0 under the diagonal A."""
    rng = np.random.default_rng(5)
    rt0, rt1 = dc.core3d(16, 6, 5), dc.core3d(16, 4, 4, k=1)
    return {"rt0": (rt0, rng.standard_normal((1, 16, 6, 5)), {}),
            "rt1": (rt1, rng.standard_normal((8, 16, 4, 4)), {}),
            "rt0_batched": (rt0, rng.standard_normal((2, 1, 16, 6, 5)), {"batched": True}),
            "rt0_diag": (rt0, rng.standard_normal((1, 16, 6, 5)), {"a_mode": "diag"})}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parttri")
    cases = [{"name": nm, "solve": (*_factors(nm), _rhs(nm))} for nm in SOLVES]
    cases += [dict(kw, name=nm, schur=data, v=v) for nm, (data, v, kw) in _schur_data().items()]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(dc.spawn_world, P_RANKS, "parttri_cases", cases, tmp / "four", 240.0)
        one = pool.submit(dc.spawn_world, 1, "parttri_cases",
                          [{"name": "p1", "solve": (*_factors("p1"), _rhs("p1"))}],
                          tmp / "one", 240.0)
        return four.result(), one.result()


@pytest.mark.parametrize("name", SOLVES + ("p1",))
def test_partitioned_solve_on_ranks_matches_jax_global(ranks, name):
    four, one = ranks
    per_rank = [r[name] for r in (one if name == "p1" else four)]
    x = np.concatenate([body for body, _ in per_rank] + [per_rank[-1][1]], axis=2)
    dinv, l = _factors(name)
    want = _global_solve(dinv, l, _rhs(name))
    np.testing.assert_allclose(x, want, rtol=5e-11, atol=5e-11)


def _port_unfused(data, v, key="d2", batched=False, a_mode="exact"):
    """The port's unfused chain of the z direction, unsharded: group 0, or
    every group at once (``batched``)."""
    from neutfem_tpu_torch.ops.apply import _face_out, _face_rhs, dir_factors, solve_A_dir
    from neutfem_tpu_torch.ops.context import build_context
    from neutfem_tpu_torch.power import ctx_group

    fes, ng, xs, bcs = dc.port_problem(data)
    ctx = build_context(fes, ng, xs, bcs, "cpu", torch.float64, a_mode=a_mode)
    ctxg = ctx if batched else ctx_group(ctx, 0)
    di = next(d for d in fes.dirs if d.axis == 0)
    BXt = di.BXc if fes.et.nbub else di.BX[:2]
    vt = torch.as_tensor(v)
    F, _ = solve_A_dir(fes, di, rF=_face_rhs(di, vt, BXt), rW=None, a_mode=a_mode,
                       **dir_factors(ctxg, key))
    return _face_out(di, F, BXt).numpy()


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("order", ["rt0", "rt1", "rt0_batched", "rt0_diag"])
def test_partitioned_schur_dir_matches_unfused_chain(ranks, order):
    """ADVICE.md's missing test, the port's side: the partitioned cut-axis
    direction equals the unfused chain, and the partitioned path ran (one
    application on every rank); also on both groups at once (the bundle
    with its group axis) and under the diagonal A (the elementwise cut
    solve)."""
    four, _ = ranks
    data, v, kw = _schur_data()[order]
    want = _port_unfused(data, v, **kw)
    for r in four:
        got, count = r[order]
        assert count == 1
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("order", ["rt0", "rt1"])
def test_jax_partitioned_schur_dir_matches_its_unfused_chain(ranks, order, monkeypatch):
    """The reference side: the JAX function on the 8-device virtual mesh
    against the JAX unfused chain (1e-12), its ``_segments_solve`` counted,
    and the port's result against it (1e-12)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from neutfem_tpu.bc import BCKind, BCSpec
    from neutfem_tpu.fespace import make_fespace
    from neutfem_tpu.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu.ops.apply import _face_out, _face_rhs, solve_A_dir
    from neutfem_tpu.ops.context import build_context
    from neutfem_tpu.parallel import device_mesh, shard_context
    from neutfem_tpu.power import ctx_group

    data, v, _ = _schur_data()[order]
    breaks, k, m, xs, dim = data
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            bcs.set(boundary_attribute(dim, ax, up), BCKind.DIRICHLET)
    ctx = build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    di = next(d for d in fes.dirs if d.axis == 0)
    BXt = di.BXc if fes.et.nbub else di.BX[:2]
    g = ctx_group(ctx, 0)

    @jax.jit
    def unfused(vv):
        F, _ = solve_A_dir(fes, di, g["tri_dinv_d2"], g["tri_l_d2"], g["mask_d2"],
                           g["alpha_d2"], _face_rhs(di, vv, jnp.asarray(BXt)), None, "exact")
        return _face_out(di, F, jnp.asarray(BXt))

    want = np.asarray(unfused(jnp.asarray(v)))

    calls = []
    segments = j_parttri._segments_solve
    monkeypatch.setattr(j_parttri, "_segments_solve",
                        lambda *a, **kw: calls.append(1) or segments(*a, **kw))
    dmesh = device_mesh(8)
    ctx_sh = ctx_group(shard_context(ctx, dmesh, fes, grid_axis=0), 0)
    got = jax.jit(lambda vv, c: j_parttri.partitioned_schur_dir(
        fes, di, vv, c, "d2", dmesh, {0: dmesh.axis_names[0]}, BXt))(jnp.asarray(v), ctx_sh)
    assert got is not None and len(calls) == 1
    assert _rel(np.asarray(got), want) <= 1e-12
    port = ranks[0][0][order][0]
    assert _rel(port, np.asarray(got)) <= 1e-12
