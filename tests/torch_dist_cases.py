"""Ranks of the port's multi-device CPU tests (``test_torch_parallel.py``,
``test_torch_parttri.py``, ``test_torch_parallel_variants.py``).

``spawn_world`` starts one process per rank (the spawn start method, a
``file://`` rendezvous in the test's temporary directory, gloo), runs one of
the rank targets below on every rank with all the cases of that world, and
returns each rank's results; a rank that fails, or a world that outlives its
deadline, kills every rank and fails the test.  This module imports neither
JAX nor the JAX package, so a rank imports torch and the port only; the
problems are numpy data that the tests give to both packages.
"""

from __future__ import annotations

import os

import numpy as np


def het2d(nx=12, ny=16, k=0):
    """``test_cmfd_coarse.build_het_problem``'s data: a heterogeneous 2-group
    2D core (fuel centre, reflector ring), vacuum (DIRICHLET) on every face.
    Returns (breaks (x, y), k, m, xs, dim)."""
    shape = (1, ny, nx)
    fuel = np.zeros(shape, dtype=bool)
    fuel[:, 2:-2, 2:-2] = True
    return ((np.linspace(0, 120, nx + 1), np.linspace(0, 120, ny + 1)), k, k,
            _xs(fuel, 2), 2)


def core3d(nz=16, ny=12, nx=8, k=0):
    """``tests/test_parallel.py``'s ``_problem_3d`` data: a heterogeneous
    2-group 3D core, vacuum on every face."""
    shape = (nz, ny, nx)
    fuel = np.zeros(shape, bool)
    fuel[2:-2, 2:-2, 2:-2] = True
    breaks = (np.linspace(0, 10.0 * nx, nx + 1), np.linspace(0, 10.0 * ny, ny + 1),
              np.linspace(0, 10.0 * nz, nz + 1))
    return breaks, k, k, _xs(fuel, 2), 3


def _xs(fuel, ng):
    xs = {
        "D": np.stack([np.where(fuel, 1.4, 1.8), np.where(fuel, 0.4, 0.5)]),
        "SigR": np.stack([np.where(fuel, 0.028, 0.021), np.where(fuel, 0.10, 0.04)]),
        "NSF": np.stack([np.where(fuel, 0.006, 0.0), np.where(fuel, 0.138, 0.0)]),
        "Chi": np.stack([np.ones(fuel.shape), np.zeros(fuel.shape)]),
        "SigS": np.zeros((ng, ng, *fuel.shape)),
        "SRC": np.zeros((ng, *fuel.shape)),
    }
    xs["SigS"][1, 0] = np.where(fuel, 0.018, 0.020)
    return xs


def source2d(nx=8, ny=8):
    """``het2d``'s core made subcritical (nu-Sigma_f x 0.5) with a unit fast
    source in the fuel: the fixed-source and subcritical solves' data."""
    breaks, k, m, xs, dim = het2d(nx, ny)
    xs = dict(xs, NSF=0.5 * xs["NSF"], SRC=xs["SRC"].copy())
    xs["SRC"][0] = np.where(xs["NSF"][1] > 0, 1.0, 0.0)
    return breaks, k, m, xs, dim


def random2d(nx=6, ny=4, seed=4):
    """A random 2-group 2D problem (``chip_smoke.py``'s CMFD "wielandt"
    recipe, where the low-order eigensolve converges), unit-ish cells."""
    rng = np.random.default_rng(seed)
    shape = (1, ny, nx)
    breaks = tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
                   for n in (nx, ny))
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    return breaks, 0, 0, xs, 2


def random3d(nz=2, ny=8, nx=6, seed=5):
    """``random2d``'s recipe on a 3D grid: a random 2-group problem with
    unit-ish cells, fission in every cell (an axis of 2 cells still holds a
    core, where ``core3d``'s fuel needs 5)."""
    rng = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    breaks = tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
                   for n in (nx, ny, nz))
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    return breaks, 0, 0, xs, 3


def plant_block(blk, cell, emax):
    """A copy of the block-Jacobi ingredients ``blk`` (``build_host_context``)
    in which the block of flat cell index ``cell``, in every group, is I + a
    (e0 e1^T + e1 e0^T) after equilibration: its inverse's largest deviation
    from I is the off-diagonal pair, |-a / (1 - a^2)| = ``emax``."""
    a = (np.sqrt(1.0 + 4.0 * emax * emax) - 1.0) / (2.0 * emax)
    P = int(round(np.sqrt(blk["coefs"].shape[0])))
    m = np.zeros((P, P))
    m[0, 1] = m[1, 0] = a
    ng, J, *shape = blk["fields"].shape
    at = (slice(None), slice(None)) + np.unravel_index(cell, shape)
    fields = np.concatenate([blk["fields"], np.zeros((ng, 1, *shape))], axis=1)
    fields[at] = 0.0
    fields[(slice(None), J) + at[2:]] = 1.0
    C, pre = blk["C"].copy(), blk["pre"].copy()
    C[at] = pre[at] = 1.0
    return {"coefs": np.concatenate([blk["coefs"], m.reshape(-1, 1)], axis=1), "fields": fields,
            "C": C, "pre": pre}


def bc_kinds(dim, periodic=(), faces=None):
    """{(axis (0 = x), upper end): (kind name, value)}: DIRICHLET, PERIODIC
    on the axes in ``periodic``, then ``faces`` on top; the same spec builds
    both packages' boundary conditions."""
    out = {(ax, up): ("PERIODIC" if ax in periodic else "DIRICHLET", 0.0)
           for ax in range(dim) for up in (False, True)}
    out.update(faces or {})
    return out


def port_problem(data, periodic=(), faces=None):
    """(fes, ng, xs, bcs) of the port from ``het2d`` / ``core3d`` data; the
    axes in ``periodic`` (0 = x) get PERIODIC faces, ``faces`` as in
    ``bc_kinds``."""
    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh, boundary_attribute

    breaks, k, m, xs, dim = data
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for (ax, up), (kind, value) in bc_kinds(dim, periodic, faces).items():
        bcs.set(boundary_attribute(dim, ax, up), BCKind[kind], value)
    return fes, 2, xs, bcs


def spawn_world(world: int, target: str, cases, tmp_path, timeout: float):
    """Run ``target`` (a function of this module) on ``world`` spawned ranks
    with ``cases`` (``parallel.spawn_ranks``); returns the ranks' results in
    rank order.  Any rank's error, or the deadline, kills every rank and
    raises."""
    from neutfem_tpu_torch import parallel

    os.makedirs(tmp_path, exist_ok=True)
    init = f"file://{os.path.join(str(tmp_path), f'rendezvous_{target}_{world}')}"
    return parallel.spawn_ranks(_rank_main, world, init, (target, cases), timeout)


def _rank_main(rank, world, init, args):
    import torch

    torch.set_num_threads(1)
    target, cases = args
    return globals()[target](rank, world, init, cases)


def _mesh(rank, world, init, shape):
    from neutfem_tpu_torch import parallel

    return parallel.device_mesh("gloo", shape, init_method=init, rank=rank, world_size=world)


def solve_cases(rank, world, init, cases):
    """Each case {"name", "data", "grid_axis", "shape", "opts", "adjoint"}:
    the sharded power iteration from the flat flux; the rank's k, counts and
    history, the gathered flux and face current on every rank, and the
    partitioned- and scan-solve applications.  A case with "memory" instead
    returns the context bytes of the rank's slab and of the whole problem,
    one with "indivisible" ``_indivisible``'s refusals."""
    import torch

    from neutfem_tpu_torch import parallel, tracing
    from neutfem_tpu_torch.ops import parttri
    from neutfem_tpu_torch.ops.context import build_host_context, context_to_device
    from neutfem_tpu_torch.power import SolveOptions

    out = {}
    meshes = {}
    for case in cases:
        shape = case.get("shape")
        if shape not in meshes:
            meshes[shape] = _mesh(rank, world, init, shape)
        mesh = meshes[shape]
        if case.get("indivisible"):
            out[case["name"]] = _indivisible(mesh)
            continue
        if case.get("plant"):
            out[case["name"]] = _planted_storage(mesh, case)
            continue
        fes, ng, xs, bcs = port_problem(case["data"])
        ga = case["grid_axis"]
        host = build_host_context(fes, ng, xs, bcs)
        ctx = parallel.shard_context(host, mesh, fes, ga, device="cpu", dtype=torch.float64)
        if case.get("memory"):
            full = context_to_device(*host, fes.P, "cpu", torch.float64)
            out[case["name"]] = {
                "local": {k: v.numel() * v.element_size() for k, v in ctx.items()},
                "full": {k: v.numel() * v.element_size() for k, v in full.items()}}
            continue
        phi0 = torch.ones((ng, *fes.mesh.shape, fes.P), dtype=torch.float64)
        run, _ = parallel.sharded_power_iteration(fes, ng, SolveOptions(**case["opts"]), mesh,
                                                  ga)
        before = (tracing.total(parttri.PARTTRI), tracing.total(parttri.SCAN))
        res = run(ctx, parallel.shard_state(phi0, mesh, ga), 1.0,
                  adjoint=case.get("adjoint", False))
        # collectives: every rank gathers, rank 0 reports
        phi = parallel.gather_state(res["phi"], mesh, ga)
        J = {key: parallel.gather_state(e["face"], mesh, ga, face_axis=3 - int(key[1]) - 1)
             for key, e in res["J"].items()}
        out[case["name"]] = {
            "keff": float(res["keff"]), "outers": res["outer_iterations"],
            "inners": res["inner_iterations"], "history": res["history"].numpy(),
            "finite": bool(res["finite"]), "local_phi_shape": tuple(res["phi"].shape),
            "phi": phi.numpy() if rank == 0 else None,
            "J": {k: v.numpy() for k, v in J.items()} if rank == 0 else None,
            "parttri": tracing.total(parttri.PARTTRI) - before[0],
            "scan": tracing.total(parttri.SCAN) - before[1], "cg": res["sharding"]["cg"]}
    return out


def unsharded_cases(rank, world, init, cases):
    """The port's single-device solve of each case {"name", "data", "opts",
    "adjoint"}: (k, outers, flux, face currents)."""
    import torch

    from neutfem_tpu_torch.ops.context import build_context
    from neutfem_tpu_torch.power import SolveOptions, power_iteration

    out = {}
    for case in cases:
        fes, ng, xs, bcs = port_problem(case["data"])
        ctx = build_context(fes, ng, xs, bcs, "cpu", torch.float64)
        phi0 = torch.ones((ng, *fes.mesh.shape, fes.P), dtype=torch.float64)
        res = power_iteration(fes, ng, SolveOptions(**case["opts"]), ctx, phi0, 1.0,
                              adjoint=case["adjoint"])
        out[case["name"]] = (float(res["keff"]), res["outer_iterations"], res["phi"].numpy(),
                             {k: e["face"].numpy() for k, e in res["J"].items()})
    return out


#: the grid axis of ``_indivisible``'s cut: 9 cells over 2 ranks
INDIVISIBLE_CELLS = 9


def _indivisible(mesh):
    """{"shard_context", "shard_state": the exception each raised ("" if
    none)} on a 1D y-cut of an axis of ``INDIVISIBLE_CELLS`` cells, which 2
    ranks do not divide."""
    import torch

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.ops.context import build_host_context

    f, g, x, b = port_problem(het2d(8, INDIVISIBLE_CELLS))
    calls = {
        "shard_context": lambda: parallel.shard_context(build_host_context(f, g, x, b), mesh, f,
                                                        1, device="cpu", dtype=torch.float64),
        "shard_state": lambda: parallel.shard_state(
            torch.ones((g, *f.mesh.shape, 1), dtype=torch.float64), mesh, 1),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = ""
        except Exception as e:  # reported to the test, which names what it wants
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _planted_storage(mesh, case):
    """The storage of the rank's float32 block preconditioner (key and dtype)
    when ``plant_block`` plants a block of max|Binv - I| = ``case["plant"][1]``
    at flat cell ``case["plant"][0]`` of the whole problem, cut along
    ``case["grid_axis"]``."""
    import torch

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.ops.context import build_host_context

    fes, ng, xs, bcs = port_problem(case["data"])
    ctx_np, blk = build_host_context(fes, ng, xs, bcs)
    host = (ctx_np, plant_block(blk, *case["plant"]))
    ctx = parallel.shard_context(host, mesh, fes, case["grid_axis"], device="cpu",
                                 dtype=torch.float32)
    return {k: str(v.dtype) for k, v in ctx.items() if k.startswith("precond_blk")}


def _variant_problem(case, device):
    """(fes, ng, xs, bcs, the whole problem's host context) of a variant
    case; with "direct" the host context carries the dense Schur factors
    (``ops/direct.attach_dense_schur`` on the whole problem)."""
    import torch

    from neutfem_tpu_torch.ops.context import build_host_context, context_to_device
    from neutfem_tpu_torch.ops.direct import attach_dense_schur

    fes, ng, xs, bcs = port_problem(case["data"], case.get("periodic", ()), case.get("faces"))
    host = build_host_context(fes, ng, xs, bcs, a_mode=case.get("a_mode", "exact"))
    if case.get("direct"):
        whole = context_to_device(*host, fes.P, device, torch.float64)
        attach_dense_schur(fes, whole, case.get("a_mode", "exact"))
        host[0].update({k: whole[k].cpu().numpy() for k in ("schur_chol", "schur_sdi")})
    return fes, ng, xs, bcs, host


def run_variant(case, fes, ng, xs, bcs, ctx, phi0, device):
    """One variant case on ``ctx`` / ``phi0`` (a rank's slab under the
    caller's sharding scope, or the whole problem): "run" is "power"
    (``power_iteration`` with ``case["opts"]``), "fixed_source",
    "subcritical" or "coarse" (``coarse_init`` with ``case["factors"]``,
    then the power iteration from its flux and k).  Returns the result dict
    (its k for "coarse" the fine solve's, the coarse one as "k_coarse")."""
    import torch

    from neutfem_tpu_torch import coarse, power

    opts = power.SolveOptions(**case["opts"])
    run = case.get("run", "power")
    if run == "fixed_source":
        return power.fixed_source_solve(fes, ng, opts, ctx, phi0,
                                        with_fission=case.get("with_fission", True),
                                        keff=case.get("keff", 1.0))
    if run == "subcritical":
        return power.solve_subcritical(fes, ng, opts, ctx, phi0, keff=case.get("keff", 1.0))
    if run == "coarse":
        k_c, phi_c = coarse.coarse_init(fes, ng, xs, bcs, case["factors"], opts, device,
                                        torch.float64)
        res = power.power_iteration(fes, ng, opts, ctx, phi_c, float(k_c))
        return dict(res, k_coarse=float(k_c), phi_coarse=phi_c)
    return power.power_iteration(fes, ng, opts, ctx, phi0, 1.0)


def _summary(res, phi, rank):
    """The observables of a variant's result: k (or None), counts, history,
    finite, M, and the gathered flux on rank 0."""
    hist = res.get("history")
    return {"keff": float(res["keff"]) if "keff" in res else None,
            "k_coarse": res.get("k_coarse"), "outers": res["outer_iterations"],
            "inners": res["inner_iterations"],
            "history": None if hist is None else hist.numpy(),
            "finite": bool(res["finite"]),
            "amplification": (float(res["amplification"]) if "amplification" in res
                              else None),
            "phi": phi.numpy() if rank == 0 else None}


def variant_cases(rank, world, init, cases):
    """Each case (``run_variant``'s, with "grid_axis" and the mesh "shape";
    "parttri_off": the context sliced under ``NEUTFEM_PARTTRI=0``): the
    rank's slab of the whole problem's context and flat flux, the variant
    under a sharding scope, its observables (``_summary``) with the gathered
    flux (and with "currents" the gathered face currents), the coarse flux
    for "coarse", the partitioned- and scan-solve applications and the
    collectives of the run."""
    import torch

    from neutfem_tpu_torch import parallel, shardctx, tracing
    from neutfem_tpu_torch.ops import parttri

    out, meshes = {}, {}
    for case in cases:
        shape = case.get("shape")
        if shape not in meshes:
            meshes[shape] = _mesh(rank, world, init, shape)
        mesh, ga = meshes[shape], case["grid_axis"]
        fes, ng, xs, bcs, host = _variant_problem(case, "cpu")
        if case.get("parttri_off"):
            os.environ["NEUTFEM_PARTTRI"] = "0"
        try:
            ctx = parallel.shard_context(host, mesh, fes, ga, device="cpu", dtype=torch.float64)
        finally:
            os.environ.pop("NEUTFEM_PARTTRI", None)
        phi0 = parallel.shard_state(torch.ones((ng, *fes.mesh.shape, fes.P),
                                               dtype=torch.float64), mesh, ga)
        before = (tracing.total(parttri.PARTTRI), tracing.total(parttri.SCAN),
                  tracing.total("comm.collectives"))
        with shardctx.sharding_scope(mesh, parallel._axis_map(mesh, ga)):
            res = run_variant(case, fes, ng, xs, bcs, ctx, phi0, "cpu")
        counts = (tracing.total(parttri.PARTTRI) - before[0],
                  tracing.total(parttri.SCAN) - before[1],
                  tracing.total("comm.collectives") - before[2])
        got = _summary(res, parallel.gather_state(res["phi"], mesh, ga), rank)
        if "phi_coarse" in res:
            whole = parallel.gather_state(res["phi_coarse"], mesh, ga)
            got["phi_coarse"] = whole.numpy() if rank == 0 else None
        if case.get("currents"):
            J = {key: parallel.gather_state(e["face"], mesh, ga, face_axis=3 - int(key[1]) - 1)
                 for key, e in res["J"].items()}
            got["J"] = {k: v.numpy() for k, v in J.items()} if rank == 0 else None
        got["parttri"], got["scan"], got["collectives"] = counts
        out[case["name"]] = got
    return out


def variant_unsharded(rank, world, init, cases):
    """The port's single-device run of each variant case (``_summary``)."""
    import torch

    from neutfem_tpu_torch.ops.context import context_to_device

    out = {}
    for case in cases:
        fes, ng, xs, bcs, host = _variant_problem(case, "cpu")
        ctx = context_to_device(*host, fes.P, "cpu", torch.float64)
        phi0 = torch.ones((ng, *fes.mesh.shape, fes.P), dtype=torch.float64)
        res = run_variant(case, fes, ng, xs, bcs, ctx, phi0, "cpu")
        out[case["name"]] = _summary(res, res["phi"], rank)
        if "phi_coarse" in res:
            out[case["name"]]["phi_coarse"] = res["phi_coarse"].numpy()
        if case.get("currents"):
            out[case["name"]]["J"] = {k: e["face"].numpy() for k, e in res["J"].items()}
    return out


def parttri_cases(rank, world, init, cases):
    """The partitioned solve and ``partitioned_schur_dir`` on one rank.
    Case {"name", "solve": (dinv, l, rhs)}: the global LDL^T factors (face
    axis 1) and a rhs (face axis 2): the rank's body and seam solutions.
    Case {"name", "schur": data, "v": v (P, nz, ny, nx)}: the z-cut
    direction's contribution of the rank's slab of v, group 0, gathered, with
    the partitioned-path applications counted; with "batched" v is (ng, P,
    nz, ny, nx) and the context not group-sliced (the Jacobi sweep's), with
    "a_mode" the context's A-solve ("diag": the elementwise cut solve)."""
    import torch

    from neutfem_tpu_torch import parallel, tracing
    from neutfem_tpu_torch.ops import parttri
    from neutfem_tpu_torch.ops.context import build_host_context
    from neutfem_tpu_torch.power import ctx_group

    mesh = _mesh(rank, world, init, None)
    tr = mesh.axes[parallel.SPATIAL_AXIS]
    out = {}
    for case in cases:
        if "solve" in case:
            dinv, l, rhs = case["solve"]
            p, k = tr.size, tr.rank
            part = parttri.build_partitioned(dinv, l, 1, p)
            n = dinv.shape[1] - 1
            s = n // p
            body = slice(k * s, k * s + s)
            loc = {nm: torch.as_tensor(np.ascontiguousarray(part[nm][:, body]))
                   for nm in ("dinv", "vrs", "vls")}
            loc["l"] = torch.as_tensor(np.ascontiguousarray(part["l"][:, k * s:k * s + s - 1]))
            for nm in ("minv", "seamd", "seamc"):
                loc[nm] = torch.as_tensor(part[nm])
            r = torch.as_tensor(rhs)
            x, x_seam = parttri.tridiag_solve_partitioned(
                r[:, :, body].contiguous(), r[:, :, n:].contiguous(), loc, 2, tr)
            out[case["name"]] = (x.numpy(), x_seam.numpy())
            continue
        fes, ng, xs, bcs = port_problem(case["schur"])
        ctx = parallel.shard_context(build_host_context(fes, ng, xs, bcs,
                                                        a_mode=case.get("a_mode", "exact")),
                                     mesh, fes, 0, device="cpu", dtype=torch.float64)
        ctxg = ctx if case.get("batched") else ctx_group(ctx, 0)
        di = next(d for d in fes.dirs if d.axis == 0)
        v = torch.as_tensor(case["v"])
        s = v.shape[-3] // tr.size
        v_loc = v[..., tr.rank * s:(tr.rank + 1) * s, :, :].contiguous()
        before = tracing.total(parttri.PARTTRI)
        got = parttri.partitioned_schur_dir(fes, di, v_loc, ctxg, "d2", tr,
                                            di.BXc if fes.et.nbub else di.BX[:2])
        count = tracing.total(parttri.PARTTRI) - before
        whole = parallel.gather_state(got, mesh, 0, base=got.ndim - 3)
        out[case["name"]] = (whole.numpy(), count)
    return out


def scan_solve_cases(rank, world, init, cases):
    """``parttri.tridiag_solve_scan`` on one rank of a 1D mesh.  Each case
    {"name", "solve": (dinv, l, rhs, s, cyc)}: the global LDL^T factors
    (face axis 1, no T axis), a rhs (face axis 2), s faces a rank and the
    PERIODIC bundle (wt, a0, a1) or None (then the last face is the seam).
    Returns the rank's body solution, its seam solution (None but on the
    last rank of a system with a seam) and the scan applications."""
    import torch

    from neutfem_tpu_torch import parallel, tracing
    from neutfem_tpu_torch.ops import parttri

    tr = _mesh(rank, world, init, None).axes[parallel.SPATIAL_AXIS]
    out = {}
    for case in cases:
        dinv, l, rhs, s, cyc = case["solve"]
        n = world * s
        body = slice(rank * s, rank * s + s)
        if cyc is not None:  # n-1 couplings of the n folded faces: pad the end
            l = np.concatenate([l, np.zeros_like(l[:, :1])], axis=1)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).unsqueeze(1)

        prev = l[:, rank * s - 1:rank * s] if rank else np.zeros_like(l[:, :1])
        seam_d = None if cyc is not None else t(dinv[:, n:])
        bundle = None if cyc is None else (t(cyc[0][:, body]), t(cyc[1]), t(cyc[2]))
        r = torch.as_tensor(rhs)
        before = tracing.total(parttri.SCAN)
        x, x_seam = parttri.tridiag_solve_scan(
            r[:, :, body].contiguous(), None if cyc is not None else r[:, :, n:].contiguous(),
            (t(dinv[:, body]), seam_d), (t(prev), t(l[:, body])), 2, tr, bundle)
        out[case["name"]] = {"x": x.numpy(), "seam": None if x_seam is None else x_seam.numpy(),
                             "scan": tracing.total(parttri.SCAN) - before}
    return out
