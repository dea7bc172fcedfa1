"""Ranks of the port's multi-device CPU tests (``test_torch_parallel.py``,
``test_torch_parttri.py``).

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


def port_problem(data, periodic=()):
    """(fes, ng, xs, bcs) of the port from ``het2d`` / ``core3d`` data; the
    axes in ``periodic`` (0 = x) get PERIODIC faces."""
    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh, boundary_attribute

    breaks, k, m, xs, dim = data
    fes = make_fespace(CartesianMesh.from_breaks(*breaks), k, m)
    bcs = BCSpec()
    for ax in range(dim):
        for up in (False, True):
            bcs.set(boundary_attribute(dim, ax, up),
                    BCKind.PERIODIC if ax in periodic else BCKind.DIRICHLET)
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
    partitioned-solve applications.  A case with "memory" instead returns
    the context bytes of the rank's slab and of the whole problem."""
    import torch

    from neutfem_tpu_torch import parallel
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
        if case.get("declines"):
            out[case["name"]] = _declines(mesh)
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
        before = parttri.LAUNCHES["parttri"]
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
            "parttri": parttri.LAUNCHES["parttri"] - before, "cg": res["sharding"]["cg"]}
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


#: What the multi-device solve does not run yet, each raising
#: NotImplementedError on every rank before any collective.
DECLINES = ("periodic_cut", "indivisible", "thin_segments", "parttri_off", "diag", "cmfd",
            "anderson", "jacobi_sweep", "bicgstab", "fixed_source", "coarse_init")


def _declines(mesh):
    """{decline: the exception each raised ("" if none)} on a 1D y-cut."""
    import dataclasses

    import torch

    from neutfem_tpu_torch import coarse, parallel, power
    from neutfem_tpu_torch.ops.context import build_host_context
    from neutfem_tpu_torch.shardctx import sharding_scope

    opts = power.SolveOptions(max_outer=3)
    fes, ng, xs, bcs = port_problem(het2d(8, 8))
    host = build_host_context(fes, ng, xs, bcs)
    ctx = parallel.shard_context(host, mesh, fes, 1, device="cpu", dtype=torch.float64)
    phi = parallel.shard_state(torch.ones((ng, *fes.mesh.shape, 1), dtype=torch.float64),
                               mesh, 1)
    p = mesh.sizes[parallel.SPATIAL_AXIS]

    def shard(data, periodic=(), a_mode="exact"):
        f, g, x, b = port_problem(data, periodic)
        return parallel.shard_context(build_host_context(f, g, x, b, a_mode=a_mode), mesh, f,
                                      1, device="cpu", dtype=torch.float64)

    def solve(**kw):
        with sharding_scope(mesh, {1: parallel.SPATIAL_AXIS}):
            power.power_iteration(fes, ng, dataclasses.replace(opts, **kw), ctx, phi, 1.0)

    def parttri_off():
        os.environ["NEUTFEM_PARTTRI"] = "0"
        try:
            shard(het2d(8, 8))
        finally:
            del os.environ["NEUTFEM_PARTTRI"]

    def fixed_source():
        with sharding_scope(mesh, {1: parallel.SPATIAL_AXIS}):
            power.fixed_source_solve(fes, ng, opts, ctx, phi)

    def coarse_init():
        with sharding_scope(mesh, {1: parallel.SPATIAL_AXIS}):
            coarse.coarse_init(fes, ng, xs, bcs, (2, 2, 1), opts, "cpu", torch.float64)

    calls = {
        "periodic_cut": lambda: shard(het2d(8, 8), periodic=(1,)),
        "indivisible": lambda: shard(het2d(8, 4 * p + 1)),
        "thin_segments": lambda: shard(het2d(8, p)),
        "parttri_off": parttri_off,
        "diag": lambda: shard(het2d(8, 8), a_mode="diag"),
        "cmfd": lambda: solve(use_cmfd=True),
        "anderson": lambda: solve(accel="anderson"),
        "jacobi_sweep": lambda: solve(sweep="jacobi"),
        "bicgstab": lambda: solve(inner_solver="bicgstab"),
        "fixed_source": fixed_source,
        "coarse_init": coarse_init,
    }
    out = {}
    for name in DECLINES:
        try:
            calls[name]()
            out[name] = ""
        except Exception as e:  # reported to the test, which names what it wants
            out[name] = f"{type(e).__name__}: {e}"
    return out


def parttri_cases(rank, world, init, cases):
    """The partitioned solve and ``partitioned_schur_dir`` on one rank.
    Case {"name", "solve": (dinv, l, rhs)}: the global LDL^T factors (face
    axis 1) and a rhs (face axis 2): the rank's body and seam solutions.
    Case {"name", "schur": data, "v": v (P, nz, ny, nx)}: the z-cut
    direction's contribution of the rank's slab of v, group 0, gathered, with
    the partitioned-path applications counted."""
    import torch

    from neutfem_tpu_torch import parallel
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
        ctx = parallel.shard_context(build_host_context(fes, ng, xs, bcs), mesh, fes, 0,
                                     device="cpu", dtype=torch.float64)
        ctxg = ctx_group(ctx, 0)
        di = next(d for d in fes.dirs if d.axis == 0)
        v = torch.as_tensor(case["v"])
        s = v.shape[-3] // tr.size
        v_loc = v[..., tr.rank * s:(tr.rank + 1) * s, :, :].contiguous()
        before = parttri.LAUNCHES["parttri"]
        got = parttri.partitioned_schur_dir(fes, di, v_loc, ctxg, "d2", tr,
                                            di.BXc if fes.et.nbub else di.BX[:2])
        count = parttri.LAUNCHES["parttri"] - before
        whole = parallel.gather_state(got, mesh, 0, base=got.ndim - 3)
        out[case["name"]] = (whole.numpy(), count)
    return out
