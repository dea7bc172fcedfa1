"""The solver variants of the port's multi-device solve on the CPU: gloo
ranks in spawned processes, float64.

Each variant runs under a sharding scope on every rank's slab (the caller's
``shardctx.sharding_scope`` with a context from ``parallel.shard_context``)
and is held to the JAX package's single-device run of the same variant, at
the tolerances of that variant's unsharded test:

* the CG family (the Jacobi sweep, Anderson, BiCGSTAB, the diag / lumped
  A-solves and the elementwise bug-compat solve, DIRECT_LLT, coarse init, a
  PERIODIC direction across the cut, CMFD "wielandt"): |dk| <= 1e-9, the
  same outers (``test_torch_diag.py``, ``test_torch_anderson.py``), inners
  within 2 of the port's unsharded run and within 4 of the JAX package's
  (the unsharded tests' 2, plus 2 for the ranks' summation order), or 0.5% /
  1% on a long run: the 3D Jacobi sweep's 32 outers at inner_tol 1e-10 read
  661 inners sharded, 664 unsharded and 665 in the JAX package, one count
  apart on three outers (measured);
* the fixed-source and subcritical solves: the flux and M to rel 1e-9, the
  same outers (``test_torch_source.py``);
* CMFD "fixed": three outers (one correction) to 1e-9, the whole solve to
  2e-6 (``test_torch_variants.py``: its low-order CG stops at its iteration
  cap on an indefinite operator, so a whole solve does not reproduce to
  rounding).

Each is also held to the port's unsharded run (|dk| <= 1e-10; CMFD at three
outers; 1e-9 where a start-flux perturbation of 1e-15 moves that run by more,
as noted at the case), and k, the counts and the history must be the same bits on every
rank.  Engagement: the cut direction's face solve ran (``tracing``'s ``parttri.*``:
at least once a CG iteration where the exact A runs), and collectives ran.

One world of 2 ranks (a y cut, or a z cut on the 3D Jacobi case) runs every
variant, one world of 4 ranks on the (z, y) mesh the Jacobi sweep and CMFD
(two cut axes: batched segments and halos on both), and one process the
port's unsharded runs, all at the same time while this process computes the
JAX references; each spawn has a deadline that kills its ranks.
"""

import concurrent.futures

import numpy as np
import pytest

import jax_jitted
import torch_dist_cases as dc

O = dict(tol_keff=1e-7, tol_flux=1e-6, inner_tol=1e-9, max_outer=80)
O3 = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-10, max_outer=80)
SRC = dict(tol_flux=1e-8, inner_tol=1e-10, max_outer=100)
WIELANDT = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=60, accel="none",
                use_cmfd=True, cmfd_mode="wielandt", cmfd_lo_outers=20)
H2 = dc.het2d(8, 8)

#: name -> (world, case); "kind" says how the case is held: "cg" (k, the
#: same outers, inners within 2, flux), "source" (flux and M), "cmfd3" (CMFD
#: at three outers), "cmfd" (a whole CMFD solve, 2e-6)
CASES = {
    "jacobi_sweep": (2, dict(data=H2, grid_axis=1, opts=dict(O, sweep="jacobi"), kind="cg")),
    "jacobi_sweep_3d_z": (2, dict(data=dc.core3d(8, 8, 6), grid_axis=0,
                                  opts=dict(O3, sweep="jacobi"), kind="cg")),
    "anderson": (2, dict(data=H2, grid_axis=1, opts=dict(O, accel="anderson"), kind="cg")),
    "bicgstab": (2, dict(data=H2, grid_axis=1, opts=dict(O, inner_solver="bicgstab"),
                         kind="cg")),
    "diag": (2, dict(data=H2, grid_axis=1, a_mode="diag", opts=dict(O, a_mode="diag"),
                     kind="cg")),
    "lumped": (2, dict(data=H2, grid_axis=1, a_mode="lumped", opts=dict(O, a_mode="lumped"),
                       kind="cg")),
    "diag_elementwise": (2, dict(data=H2, grid_axis=1, a_mode="diag",
                                 opts=dict(O, a_mode="diag", diag_elementwise=True),
                                 kind="cg")),
    "direct_llt": (2, dict(data=H2, grid_axis=1, direct=True,
                           opts=dict(O, inner_solver="direct"), kind="cg")),
    "coarse_init": (2, dict(data=H2, grid_axis=1, run="coarse", factors=(2, 2, 1), opts=O,
                            kind="cg")),
    "fixed_source": (2, dict(data=dc.source2d(8, 8), grid_axis=1, run="fixed_source",
                             opts=dict(SRC, inner_eta=0.03), kind="source")),
    "fixed_source_only": (2, dict(data=dc.source2d(8, 8), grid_axis=1, run="fixed_source",
                                  with_fission=False, opts=SRC, kind="source")),
    # a nonzero NEUMANN face on the cut axis: the lift (src_bc, jcorr) on
    # the slabs
    "fixed_source_neumann": (2, dict(data=dc.source2d(8, 8), grid_axis=1, run="fixed_source",
                                     faces={(1, False): ("NEUMANN", 0.5)}, keff=1.1, opts=SRC,
                                     kind="source")),
    "subcritical": (2, dict(data=dc.source2d(8, 8), grid_axis=1, run="subcritical", opts=SRC,
                            kind="source")),
    "cmfd_fixed_3_outers": (2, dict(data=H2, grid_axis=1,
                                    opts=dict(O, use_cmfd=True, max_outer=3), kind="cmfd3")),
    "cmfd_fixed": (2, dict(data=H2, grid_axis=1,
                           opts=dict(O, use_cmfd=True, tol_keff=1e-6, tol_flux=1e-5),
                           kind="cmfd")),
    # the low-order eigensolve converges on this problem (chip_smoke.py's
    # "wielandt" recipe); its PERIODIC x lies across the y cut
    "cmfd_wielandt": (2, dict(data=dc.random2d(6, 4), periodic=(0,), grid_axis=1,
                              opts=WIELANDT, kind="cg")),
    # a PERIODIC direction across the cut: the cyclic solve on the rank's
    # complete x lines, CMFD's wrap-around padding local
    "periodic_across_cut": (2, dict(data=H2, periodic=(0,), grid_axis=1, opts=O, kind="cg")),
    # with x PERIODIC the correction amplifies rounding: a 1e-15 change of
    # the start flux moves the port's unsharded k at three outers by up to
    # 6.2e-10 (measured), so the two runs are held to 1e-9 here
    "periodic_across_cut_cmfd": (2, dict(data=H2, periodic=(0,), grid_axis=1,
                                         opts=dict(O, use_cmfd=True, max_outer=3),
                                         kind="cmfd3", port_dk=1e-9)),
    "zy_jacobi_sweep": (4, dict(data=dc.core3d(8, 8, 6), grid_axis=(0, 1), shape=(2, 2),
                                opts=dict(O3, sweep="jacobi"), kind="cg")),
    "zy_cmfd_fixed_3_outers": (4, dict(data=dc.core3d(8, 8, 6), grid_axis=(0, 1),
                                       shape=(2, 2), opts=dict(O3, use_cmfd=True, max_outer=3),
                                       kind="cmfd3")),
}
#: the exact A runs the partitioned solve once a CG iteration at least
EXACT_CG = {nm for nm, (_, c) in CASES.items()
            if c.get("a_mode", "exact") == "exact" and c["opts"].get("inner_solver") != "direct"}
TIMEOUT = 300.0


def _cases(world):
    return [dict(c, name=nm) for nm, (w, c) in CASES.items() if w == world]


def _jax_run(case):
    """The JAX package's single-device run of a case: its k (None for the
    fixed-source solves), outers, inners, flux and M."""
    import jax.numpy as jnp

    from neutfem_tpu import coarse, power
    from neutfem_tpu.bc import BCKind, BCSpec
    from neutfem_tpu.fespace import make_fespace
    from neutfem_tpu.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu.ops.context import build_context
    from neutfem_tpu.ops.direct import attach_dense_schur

    breaks, k, m, xs, dim = case["data"]
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for (ax, up), (kind, value) in dc.bc_kinds(dim, case.get("periodic", ()),
                                               case.get("faces")).items():
        bcs.set(boundary_attribute(dim, ax, up), BCKind[kind], value)
    a_mode = case.get("a_mode", "exact")
    ctx = build_context(fes, 2, xs, bcs, a_mode=a_mode, dtype=jnp.float64)
    if case.get("direct"):
        attach_dense_schur(fes, ctx, a_mode)
    opts = power.SolveOptions(**case["opts"])
    phi0 = jnp.ones((2, *fes.mesh.shape, fes.P), dtype=jnp.float64)
    run = case.get("run", "power")
    if run == "fixed_source":
        res = jax_jitted.fixed_source_solve(fes, 2, opts, ctx, phi0,
                                            with_fission=case.get("with_fission", True),
                                            keff=case.get("keff", 1.0))
    elif run == "subcritical":
        res = jax_jitted.solve_subcritical(fes, 2, opts, ctx, phi0, keff=case.get("keff", 1.0))
    elif run == "coarse":
        k_c, phi_c = coarse.coarse_init(fes, 2, xs, bcs, case["factors"], opts, jnp.float64)
        res = jax_jitted.power_iteration(fes, 2, opts, ctx, phi_c, k_c)
    else:
        res = jax_jitted.power_iteration(fes, 2, opts, ctx, phi0, 1.0)
    return {"keff": float(res["keff"]) if "keff" in res else None,
            "outers": int(res["outer_iterations"]), "inners": int(res["inner_iterations"]),
            "phi": np.asarray(res["phi"]),
            "amplification": (float(res["amplification"]) if "amplification" in res
                              else None)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results per rank, the port's unsharded runs, and the
    JAX references, all computed at the same time."""
    tmp = tmp_path_factory.mktemp("ranks")
    every = [dict(c, name=nm) for nm, (_, c) in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        worlds = {w: pool.submit(dc.spawn_world, w, "variant_cases", _cases(w), tmp / str(w),
                                 TIMEOUT) for w in (2, 4)}
        port = pool.submit(dc.spawn_world, 1, "variant_unsharded", every, tmp / "unsharded",
                           TIMEOUT)
        jax_refs = {c["name"]: _jax_run(c) for c in every}
        ranks = {w: f.result() for w, f in worlds.items()}
        port_refs = port.result()[0]
    return ranks, port_refs, jax_refs


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_variant_matches_single_device(runs, name):
    ranks, port_refs, jax_refs = runs
    world, case = CASES[name]
    per_rank = [r[name] for r in ranks[world]]
    got, port, ref = per_rank[0], port_refs[name], jax_refs[name]
    # every rank read the same stop tests: k, the counts and the history
    for other in per_rank[1:]:
        assert (other["keff"], other["outers"], other["inners"]) == (
            got["keff"], got["outers"], got["inners"])
        assert other["amplification"] == got["amplification"]
        if got["history"] is not None:
            assert np.array_equal(other["history"], got["history"])
    assert got["finite"]
    kind = case["kind"]
    if kind == "cmfd":
        assert abs(got["keff"] - ref["keff"]) <= 2e-6
        assert abs(got["keff"] - port["keff"]) <= 2e-6
    elif kind == "source":
        assert got["outers"] == ref["outers"] == port["outers"] > 1
        assert abs(got["inners"] - ref["inners"]) <= 2
        assert _rel(got["phi"], ref["phi"]) <= 1e-9
        assert _rel(got["phi"], port["phi"]) <= 1e-9
        if got["amplification"] is not None:
            assert abs(got["amplification"] / ref["amplification"] - 1.0) <= 1e-9
            assert abs(got["amplification"] / port["amplification"] - 1.0) <= 1e-10
    else:
        assert abs(got["keff"] - ref["keff"]) <= 1e-9
        assert abs(got["keff"] - port["keff"]) <= case.get("port_dk", 1e-10)
        assert got["outers"] == ref["outers"] == port["outers"]
        # the ranks' summation order moves inner counts by rounding: within
        # 2 (0.5% on a long run) of the port's unsharded run, which its own
        # tests hold within 2 of the JAX package
        assert abs(got["inners"] - port["inners"]) <= max(2, 0.005 * port["inners"])
        assert abs(got["inners"] - ref["inners"]) <= max(4, 0.01 * ref["inners"])
        # CMFD's low-order CG at its iteration cap lifts rounding in the
        # corrected flux (test_torch_variants.py: 1e-6)
        np.testing.assert_allclose(got["phi"], ref["phi"],
                                   rtol=1e-6 if kind == "cmfd3" else 1e-7, atol=1e-11)
    if name == "coarse_init":
        assert got["k_coarse"] == port["k_coarse"]
        assert np.array_equal(got["phi_coarse"], port["phi_coarse"])
    # engagement: the cut direction's face solve and the collectives ran
    assert got["collectives"] > 0
    assert got["parttri"] >= (got["inners"] if name in EXACT_CG else 1)

