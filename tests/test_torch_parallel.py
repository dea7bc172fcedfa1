"""The port's multi-device solve (``neutfem_tpu_torch/parallel.py``) on the CPU:
gloo ranks in spawned processes, float64, the counterparts of
``tests/test_parallel.py``'s seven cases.

Each sharded solve is held to the JAX package's single-device
``power_iteration`` on the same problem (|dk| <= 1e-9, the same outer count,
the gathered flux to rtol 1e-7) and to the port's unsharded solve (|dk| <=
1e-10); k, the counts and the history must be identical bit for bit on every
rank.  The 2D solves run at tol_keff 1e-7 / tol_flux 1e-6 / inner 1e-9,
looser than ``test_parallel.py``'s, so the ranks' collectives (a few hundred
µs each on gloo) keep the file within its time: the comparison is of two
implementations of one iteration; the 3D ones at ``test_parallel.py``'s.

A block planted in one rank's slab (``torch_dist_cases.plant_block``) holds
the float32 storage decision of the block preconditioner to the whole
context's: both ranks store the bfloat16 inverse, though the other rank's
slab alone would take the fp8 E-form.

All cases of one world run in one spawn (``torch_dist_cases.spawn_world``),
the world of 4 ranks and two of 2 at the same time, while this process computes
the references; each spawn has a deadline that kills its ranks.
"""

import concurrent.futures

import numpy as np
import pytest

import jax_jitted
import torch_dist_cases as dc

OPTS = dict(tol_keff=1e-7, tol_flux=1e-6, inner_tol=1e-9, max_outer=80)
#: the 3D cases at ``test_parallel.py``'s own 3D options: at inner_tol 1e-9
#: the two summation orders part by up to 7e-7 in the smallest flux entries
OPTS3D = dict(tol_keff=1e-8, tol_flux=1e-7, inner_tol=1e-10, max_outer=60)
LINE = dict(OPTS3D, inner_precond="line")

#: name -> (world, data, grid axis, mesh shape, options, adjoint); the
#: 2-rank cases run as two worlds ("2a", "2b") at the same time
CASES = {
    "y2d": (4, dc.het2d(12, 16), 1, None, OPTS, False),
    "zy": (4, dc.core3d(8, 16, 8), (0, 1), (2, 2), OPTS3D, False),
    "rt1": ("2a", dc.het2d(8, 8, k=1), 1, None, OPTS, False),
    "rt1_adjoint": ("2a", dc.het2d(8, 8, k=1), 1, None, OPTS, True),
    "z3d": ("2b", dc.core3d(16, 12, 8), 0, None, OPTS3D, False),
    "line_orthogonal": ("2b", dc.core3d(12, 16, 8), 1, None, LINE, False),
    "line_along_cut": ("2a", dc.core3d(16, 12, 8), 0, None, LINE, False),
    # 3D RT1-P1, y cut: the condensed chain on the cut y; x and z on the
    # rank's lines with the x operands restaged from the slab
    "rt1_3d": ("2b", dc.core3d(6, 8, 6, k=1), 1, None, OPTS3D, False),
}
WORLDS = {4: 4, "2a": 2, "2b": 2}
#: a case held to another's references: the line along the cut is left
#: out, so the sharded solve is the single-device Jacobi solve of z3d ("auto"
#: resolves to Jacobi at this size)
SAME_REF = {"line_along_cut": "z3d"}
TIMEOUT = 300.0
#: a 3D RT1-P1 problem cut along y over "2a"'s two ranks, and the block
#: planted in it (flat cell (z, y, x) = (1, 6, 2): rank 1's slab) with its
#: max|Binv - I| over e4m3's 440
PLANT_DATA, PLANT = dc.core3d(4, 8, 6, k=1), (1 * 48 + 6 * 6 + 2, 441.0)


def _spawn(world, tmp_path):
    cases = [{"name": nm, "data": c[1], "grid_axis": c[2], "shape": c[3], "opts": c[4],
              "adjoint": c[5]} for nm, c in CASES.items() if c[0] == world]
    if world == 4:
        cases.append({"name": "memory", "data": dc.het2d(12, 16), "grid_axis": 1,
                      "memory": True})
    elif world == "2b":
        cases.append({"name": "indivisible", "indivisible": True})
    else:
        cases.append({"name": "fp8_whole", "data": PLANT_DATA, "grid_axis": 1,
                       "plant": PLANT})
    return dc.spawn_world(WORLDS[world], "solve_cases", cases, tmp_path / str(world),
                          TIMEOUT)


def _jax_solve(data, opts, adjoint):
    import jax.numpy as jnp

    from neutfem_tpu.bc import BCKind, BCSpec
    from neutfem_tpu.fespace import make_fespace
    from neutfem_tpu.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu.ops.context import build_context
    from neutfem_tpu.power import SolveOptions

    breaks, k, m, xs, dim = data
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            bcs.set(boundary_attribute(dim, ax, up), BCKind.DIRICHLET)
    ctx = build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    phi0 = jnp.ones((2, *fes.mesh.shape, fes.P), dtype=jnp.float64)
    res = jax_jitted.power_iteration(fes, 2, SolveOptions(**opts), ctx, phi0, 1.0,
                                     adjoint=adjoint)
    return float(res["keff"]), int(res["outer_iterations"]), np.asarray(res["phi"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results per rank, and the references of every case: the
    port's unsharded solves in one more spawned process, the JAX package's
    here, all at the same time."""
    tmp = tmp_path_factory.mktemp("ranks")
    own = {nm: c for nm, c in CASES.items() if nm not in SAME_REF}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        worlds = {w: pool.submit(_spawn, w, tmp) for w in WORLDS}
        port = pool.submit(dc.spawn_world, 1, "unsharded_cases",
                           [{"name": nm, "data": c[1], "opts": c[4], "adjoint": c[5]}
                            for nm, c in own.items()], tmp / "unsharded", TIMEOUT)
        jax_refs = {nm: _jax_solve(c[1], c[4], c[5]) for nm, c in own.items()}
        ranks = {w: f.result() for w, f in worlds.items()}
        port_refs = port.result()[0]
    refs = {nm: {"jax": jax_refs[SAME_REF.get(nm, nm)], "port": port_refs[SAME_REF.get(nm, nm)]}
            for nm in CASES}
    return ranks, refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_solve_matches_single_device(runs, name):
    ranks, refs = runs
    world = CASES[name][0]
    per_rank = [r[name] for r in ranks[world]]
    got = per_rank[0]
    k_jax, outers_jax, phi_jax = refs[name]["jax"]
    k_port, outers_port, phi_port, J_port = refs[name]["port"]
    # every rank read the same stop tests: k, counts and history bit for bit
    for other in per_rank[1:]:
        assert other["keff"] == got["keff"]
        assert (other["outers"], other["inners"]) == (got["outers"], got["inners"])
        assert np.array_equal(other["history"], got["history"])
    assert got["finite"]
    assert abs(got["keff"] - k_jax) <= 1e-9
    assert got["outers"] == outers_jax == outers_port
    assert abs(got["keff"] - k_port) <= 1e-10
    np.testing.assert_allclose(got["phi"], phi_jax, rtol=1e-7, atol=1e-11)
    for key, face in J_port.items():
        np.testing.assert_allclose(got["J"][key], face, rtol=1e-7,
                                   atol=1e-8 * np.max(np.abs(face)))
    # the cut direction ran the partitioned solve: once per CG iteration and
    # per compute_current at least; the scan solve never
    assert got["parttri"] >= got["inners"]
    assert got["scan"] == 0
    assert got["cg"] == "eager"  # CPU tensors: no graphs


def test_each_rank_holds_its_slab(runs):
    ranks, _ = runs
    assert [r["y2d"]["local_phi_shape"] for r in ranks[4]] == [(2, 1, 4, 12, 1)] * 4
    assert [r["zy"]["local_phi_shape"] for r in ranks[4]] == [(2, 4, 8, 8, 1)] * 4


def test_shard_context_memory_scales(runs):
    """Per-rank context bytes ~ 1/p of the whole: the cut direction's face
    arrays split into body + seam, the partitioned bundle present (its minv
    whole on every rank), every large array at most its 1/p share."""
    ranks, _ = runs
    p = 4
    for r in ranks[4]:
        local, full = r["memory"]["local"], r["memory"]["full"]
        for name in ("tri_dinv_d1", "mask_d1", "dtilde_d1", "jscale_d1"):
            assert name + "__seam" in local, name
            assert local[name] <= full[name] // p + 1024, name
        for name in ("dinv", "l", "vrs", "vls", "minv", "seamd", "seamc"):
            assert f"tri_part_{name}_d1" in local
        big = [k for k in local if not k.endswith("__seam") and not k.startswith("tri_part_")
               and full.get(k, 0) >= full["C"] // 4]
        assert "C" in big and "tri_xT_dinvm_d0" in big
        per_rank = sum(local[k] for k in big)
        total = sum(full[k] for k in big)
        assert per_rank <= total / p + 1024 * len(big), (per_rank, total)
        # nothing the whole problem needs only unsharded is kept
        assert "tri_dinvm_d1" not in local and "tri_yT_dinvm_d1" not in local


def test_fp8_decision_is_the_whole_contexts(runs):
    """Only rank 1's slab holds the planted block: rank 0's slab alone would
    store the fp8 E-form, but the ranks reduce max|E| and both store the
    bfloat16 inverse, as the whole context does."""
    from blockjac_reference import reference_emax, reference_inverse
    from neutfem_tpu_torch.ops.context import build_host_context

    ranks, _ = runs
    fes, ng, xs, bcs = dc.port_problem(PLANT_DATA)
    blk = dc.plant_block(build_host_context(fes, ng, xs, bcs)[1], *PLANT)
    ny = fes.mesh.shape[1]
    alone = []
    for lo, hi in ((0, ny // 2), (ny // 2, ny)):
        slab = {k: v if v.ndim < 3 else v[..., lo:hi, :] for k, v in blk.items()}
        alone.append(reference_emax(reference_inverse(slab, fes.P, (4, hi - lo, 6))[0]))
    assert alone[0] < 440.0 < alone[1]
    assert [r["fp8_whole"] for r in ranks["2a"]] == [{"precond_blk_inv": "torch.bfloat16"}] * 2


def test_indivisible_axis_raises_as_jax(runs):
    """An axis that p does not divide: the port refuses it as the JAX package
    does (its ``shard_state``: ``jax.device_put`` needs even shards), with a
    ``ValueError`` that names the even slab, on every rank before any
    collective; the JAX package's on 2 devices of the virtual mesh."""
    import jax.numpy as jnp

    from neutfem_tpu import parallel as j_parallel

    ranks, _ = runs
    for r in ranks["2b"]:
        for call in ("shard_context", "shard_state"):
            got = r["indivisible"][call]
            assert got.startswith("ValueError") and "even slab" in got, got
            assert "ROADMAP" not in got
    mesh = j_parallel.device_mesh(2)
    phi = jnp.ones((2, 1, dc.INDIVISIBLE_CELLS, 8, 1))
    with pytest.raises(ValueError, match="divisible by 2"):
        j_parallel.shard_state(phi, mesh, 1)
