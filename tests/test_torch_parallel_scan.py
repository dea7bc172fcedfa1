"""The port's scan cut-axis solve (``ops/parttri.tridiag_solve_scan``) on the
CPU, float64: the cut directions the partition method does not take — a
PERIODIC cut direction, a segment of one cell, ``NEUTFEM_PARTTRI=0`` — where
the JAX package runs its GSPMD-partitioned associative scan
(``neutfem_tpu/ops/apply.py:211-259``).

* ``affine_scan`` / ``scan_solve`` (``ops/tridiag.py``) against the JAX
  package's ``affine_scan`` / ``_scan_solve`` on seeded inputs, every axis
  and direction (float64 to rtol 1e-12; float32 to 1e-5: the two scans
  associate differently);
* ``tridiag_solve_scan`` on 4 gloo ranks against the JAX package's global
  ``_scan_solve`` (rtol 1e-12): with the seam, one face a rank, and the
  PERIODIC fold with its Sherman-Morrison correction;
* the sharded power iteration of each such cut (gloo ranks spawned by
  ``torch_dist_cases.spawn_world``) held to the JAX package's single-device
  ``power_iteration`` on the same problem (|dk| <= 1e-9, the same outers,
  the gathered flux to rtol 1e-7) and to the port's unsharded solve (|dk|
  <= 1e-10; CMFD's three outers 1e-9, as ``test_torch_parallel_variants.py``
  holds CMFD on a periodic direction, its flux to 1e-7 of the largest
  entry), k, the counts and the history the
  same bits on every rank, and the scan engaged (``tracing``'s ``parttri.scan``
  at least once a CG iteration, the partitioned solve not at all);
* the diag / lumped A-solves with a PERIODIC direction: both packages
  refuse the context.

One world of 2 ranks and one of 4 run their cases while one process runs
the port's unsharded solves and this one the JAX references; each spawn has
a deadline that kills its ranks.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
import torch_dist_cases as dc
from neutfem_tpu.ops import tridiag as j_tridiag
from neutfem_tpu_torch.ops import tridiag

O = dict(tol_keff=1e-7, tol_flux=1e-6, inner_tol=1e-9, max_outer=80)
O3 = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-10, max_outer=60)
#: the RT0 periodic cases at inner_tol 1e-10: at 1e-9 the port's and the
#: JAX package's unsharded solves of ``periodic_y`` stop their CGs one
#: iteration apart (816 / 817 inners) and their fluxes part by 4.1e-7; at
#: 1e-10 by 1.5e-8 (measured; RT1-P1 agrees to 2.3e-14 at 1e-9)
OP = dict(O, inner_tol=1e-10)
H2 = dc.het2d(8, 8)

#: name -> (world, case); "kind" "cg": k, outers, flux; "cmfd3": CMFD's
#: three outers (k of the port's unsharded run to 1e-9, both fluxes to 1e-7
#: of their largest entry);
#: the 2-rank cases run as two worlds ("2a", "2b") at the same time
CASES = {
    "parttri_off_y": ("2a", dict(data=H2, grid_axis=1, parttri_off=True, opts=O, kind="cg")),
    "parttri_off_z3d": ("2a", dict(data=dc.core3d(8, 8, 6), grid_axis=0, parttri_off=True,
                                   opts=O3, kind="cg")),
    "one_cell_y": (4, dict(data=dc.random2d(8, 4), grid_axis=1, opts=O, kind="cg")),
    # (z, y) mesh: z has 2 cells over 2 ranks (one a rank, the scan), y 4
    # over 2 (the partitioned solve)
    "one_cell_zy": (4, dict(data=dc.random3d(2, 4, 4), grid_axis=(0, 1), shape=(2, 2), opts=O,
                            kind="cg")),
    "periodic_y": ("2b", dict(data=H2, periodic=(1,), grid_axis=1, opts=OP, kind="cg",
                              currents=True)),
    "periodic_y_rt1": ("2b", dict(data=dc.het2d(8, 8, k=1), periodic=(1,), grid_axis=1, opts=O,
                                  kind="cg", currents=True)),
    "periodic_y_cmfd": ("2a", dict(data=H2, periodic=(1,), grid_axis=1,
                                   opts=dict(OP, use_cmfd=True, max_outer=3), kind="cmfd3")),
    "periodic_y_jacobi": ("2a", dict(data=H2, periodic=(1,), grid_axis=1,
                                     opts=dict(OP, sweep="jacobi"), kind="cg")),
}
WORLDS = {4: 4, "2a": 2, "2b": 2}
TIMEOUT = 300.0


def _jax_run(case):
    """The JAX package's single-device power iteration of a case: k,
    outers, inners, flux."""
    from neutfem_tpu import power
    from neutfem_tpu.bc import BCKind, BCSpec
    from neutfem_tpu.fespace import make_fespace
    from neutfem_tpu.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu.ops.context import build_context

    breaks, k, m, xs, dim = case["data"]
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for (ax, up), (kind, value) in dc.bc_kinds(dim, case.get("periodic", ())).items():
        bcs.set(boundary_attribute(dim, ax, up), BCKind[kind], value)
    ctx = build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    phi0 = jnp.ones((2, *fes.mesh.shape, fes.P), dtype=jnp.float64)
    res = jax_jitted.power_iteration(fes, 2, power.SolveOptions(**case["opts"]), ctx, phi0, 1.0)
    return {"keff": float(res["keff"]), "outers": int(res["outer_iterations"]),
            "inners": int(res["inner_iterations"]), "phi": np.asarray(res["phi"])}


def _solve_data():
    """The rank-level solves: name -> (factors dinv (1, m, 3, 2), l, rhs
    (1, T, m, 3, 2), faces a rank s, cyclic bundle or None).  m = 4 s + 1
    faces with a seam; the PERIODIC fold has m = 4 s and wt, a0, a1 of a
    random cyclic corner."""
    out = {}
    for name, s, cyclic in (("seam", 3, False), ("one_face", 1, False), ("cyclic", 3, True),
                            ("cyclic_one_face", 1, True)):
        rng = np.random.default_rng(len(out))
        m = 4 * s + (0 if cyclic else 1)
        a = rng.uniform(2.5, 4.0, (1, m, 3, 2))
        b = rng.uniform(-1.0, -0.2, (1, m - 1, 3, 2))
        dinv, l = (np.asarray(t) for t in j_tridiag.tridiag_factor(jnp.asarray(a),
                                                                   jnp.asarray(b), axis=1))
        rhs = rng.standard_normal((1, 2, m, 3, 2))
        cyc = None
        if cyclic:
            cyc = tuple(rng.uniform(-0.5, 0.5, sh) for sh in ((1, m, 3, 2), (1, 1, 3, 2),
                                                              (1, 1, 3, 2)))
        out[name] = (dinv, l, rhs, s, cyc)
    return out


def _global_scan(dinv, l, rhs, cyc):
    """The JAX package's global solve of a ``_solve_data`` system (face axis
    2 of rhs), with the Sherman-Morrison correction where ``cyc`` is given."""
    d = jnp.broadcast_to(jnp.expand_dims(jnp.asarray(dinv), 1), rhs.shape)
    n = rhs.shape[2]
    lb = jnp.broadcast_to(jnp.expand_dims(jnp.asarray(l), 1),
                          rhs.shape[:2] + (n - 1,) + rhs.shape[3:])
    y = j_tridiag._scan_solve(jnp.asarray(rhs), d, lb, 2)
    if cyc is None:
        return np.asarray(y)
    wt, a0, a1 = (jnp.expand_dims(jnp.asarray(t), 1) for t in cyc)
    return np.asarray(y - wt * (a0 * y[:, :, :1] + a1 * y[:, :, n - 1:]))


def _cases(world):
    return [dict(c, name=nm) for nm, (w, c) in CASES.items() if w == world]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results per rank, the port's unsharded runs and the
    JAX references, all computed at the same time."""
    tmp = tmp_path_factory.mktemp("ranks")
    every = [dict(c, name=nm) for nm, (_, c) in CASES.items()]
    solves = _solve_data()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 2) as pool:
        worlds = {w: pool.submit(dc.spawn_world, WORLDS[w], "variant_cases", _cases(w),
                                 tmp / str(w), TIMEOUT) for w in WORLDS}
        scan = pool.submit(dc.spawn_world, 4, "scan_solve_cases",
                           [{"name": nm, "solve": v} for nm, v in solves.items()],
                           tmp / "solves", TIMEOUT)
        port = pool.submit(dc.spawn_world, 1, "variant_unsharded", every, tmp / "unsharded",
                           TIMEOUT)
        jax_refs = {c["name"]: _jax_run(c) for c in every}
        want = {nm: _global_scan(v[0], v[1], v[2], v[4]) for nm, v in solves.items()}
        ranks = {w: f.result() for w, f in worlds.items()}
        port_refs = port.result()[0]
        scan_ranks = scan.result()
    return ranks, port_refs, jax_refs, scan_ranks, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_affine_scan_matches_jax(axis, reverse, dtype):
    rng = np.random.default_rng(10 * axis + reverse)
    shape = [3, 4, 5]
    shape[axis] = 11
    a = rng.uniform(-0.95, 0.95, shape).astype(dtype)
    b = rng.standard_normal(shape).astype(dtype)
    want = np.asarray(j_tridiag.affine_scan(jnp.asarray(a), jnp.asarray(b), axis, reverse))
    got = tridiag.affine_scan(torch.as_tensor(a), torch.as_tensor(b), axis, reverse).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, rtol=1e-12 if dtype == "float64" else 1e-5,
                               atol=1e-14 if dtype == "float64" else 1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_scan_solve_matches_jax(axis, dtype):
    """``scan_solve`` with factors broadcast over a leading axis, against the
    JAX ``_scan_solve`` on the broadcast factors and the Thomas solve."""
    rng = np.random.default_rng(20 + axis)
    shape = [2, 4, 5, 6]
    shape[1 + axis] = 9
    fshape = [1] + shape[1:]
    lshape = list(fshape)
    lshape[1 + axis] -= 1
    a = rng.uniform(2.5, 4.0, fshape)
    b = rng.uniform(-1.0, -0.2, lshape)
    dinv, l = (np.asarray(t).astype(dtype) for t in j_tridiag.tridiag_factor(
        jnp.asarray(a), jnp.asarray(b), axis=1 + axis))
    r = rng.standard_normal(shape).astype(dtype)
    lb = np.broadcast_to(l, shape[:1 + axis] + [shape[1 + axis] - 1] + shape[2 + axis:])
    want = np.asarray(j_tridiag._scan_solve(
        jnp.asarray(r), jnp.asarray(np.broadcast_to(dinv, r.shape)), jnp.asarray(lb), 1 + axis))
    got = tridiag.scan_solve(torch.as_tensor(r), torch.as_tensor(dinv), torch.as_tensor(l),
                             1 + axis)
    thomas = tridiag.tridiag_solve(torch.as_tensor(r), torch.as_tensor(dinv),
                                   torch.as_tensor(l), 1 + axis)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.numpy(), thomas.numpy(), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("name", ["seam", "one_face", "cyclic", "cyclic_one_face"])
def test_rank_scan_solve_matches_global(runs, name):
    """``tridiag_solve_scan`` on 4 ranks, each with its s faces: the
    gathered solution is the JAX package's global one, with the seam face
    from the last rank; one application counted a rank."""
    _, _, _, scan_ranks, want = runs
    got = np.concatenate([r[name]["x"] for r in scan_ranks], axis=2)
    seam = scan_ranks[-1][name]["seam"]
    if seam is not None:
        got = np.concatenate([got, seam], axis=2)
    assert all(r[name]["seam"] is None for r in scan_ranks[:-1])
    np.testing.assert_allclose(got, want[name], rtol=1e-12, atol=1e-13)
    assert [r[name]["scan"] for r in scan_ranks] == [1] * 4


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_cut_matches_single_device(runs, name):
    ranks, port_refs, jax_refs, _, _ = runs
    world, case = CASES[name]
    per_rank = [r[name] for r in ranks[world]]
    got, port, ref = per_rank[0], port_refs[name], jax_refs[name]
    for other in per_rank[1:]:
        assert (other["keff"], other["outers"], other["inners"]) == (
            got["keff"], got["outers"], got["inners"])
        assert np.array_equal(other["history"], got["history"])
    assert got["finite"]
    assert abs(got["keff"] - ref["keff"]) <= 1e-9
    assert got["outers"] == ref["outers"] == port["outers"]
    if case["kind"] == "cmfd3":
        # the correction lifts rounding, most in the small entries: the
        # port's unsharded flux and the JAX package's part by 1.1e-6 entry by
        # entry and by 6.8e-9 of the largest entry, the sharded and the
        # unsharded port's by 1.5e-8 of it (measured), so both fluxes are
        # held to 1e-7 of the largest entry
        assert abs(got["keff"] - port["keff"]) <= 1e-9
        assert _rel(got["phi"], port["phi"]) <= 1e-7
        assert _rel(got["phi"], ref["phi"]) <= 1e-7
    else:
        assert abs(got["keff"] - port["keff"]) <= 1e-10
        np.testing.assert_allclose(got["phi"], ref["phi"], rtol=1e-7, atol=1e-11)
        np.testing.assert_allclose(got["phi"], port["phi"], rtol=1e-7, atol=1e-11)
    if case.get("currents"):
        for key, face in port["J"].items():
            np.testing.assert_allclose(got["J"][key], face, rtol=1e-7,
                                       atol=1e-8 * np.max(np.abs(face)))
    # engagement: the scan solve once a CG iteration at least, the
    # partitioned one only on the (z, y) mesh's y (s = 4)
    assert got["scan"] >= got["inners"] > 0
    assert got["collectives"] > 0
    assert (got["parttri"] > 0) == (name == "one_cell_zy")


@pytest.mark.parametrize("a_mode", ["diag", "lumped"])
def test_periodic_needs_the_exact_a_in_both_packages(a_mode):
    """The JAX fold runs before its ``a_mode`` test (``apply.py:245``), but
    no context reaches it: both packages refuse a PERIODIC direction under
    "diag" / "lumped" when the context is built, so no cut takes it."""
    from neutfem_tpu.bc import BCKind as JBCKind, BCSpec as JBCSpec
    from neutfem_tpu.fespace import make_fespace as j_make_fespace
    from neutfem_tpu.mesh import CartesianMesh as JMesh, boundary_attribute as j_attr
    from neutfem_tpu.ops.context import build_context as j_build_context
    from neutfem_tpu_torch.ops.context import build_host_context

    breaks, k, m, xs, dim = H2
    jbcs = JBCSpec()
    for (ax, up), (kind, _) in dc.bc_kinds(dim, (1,)).items():
        jbcs.set(j_attr(dim, ax, up), JBCKind[kind])
    with pytest.raises(ValueError, match="PERIODIC boundaries require a_mode='exact'"):
        j_build_context(j_make_fespace(JMesh.from_breaks(*breaks), k, m), 2, xs, jbcs,
                        a_mode=a_mode, dtype=jnp.float64)
    fes, ng, xs, bcs = dc.port_problem(H2, periodic=(1,))
    with pytest.raises(ValueError, match="PERIODIC boundaries require a_mode='exact'"):
        build_host_context(fes, ng, xs, bcs, a_mode=a_mode)
