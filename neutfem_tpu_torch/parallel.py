"""The multi-device solve on ``torch.distributed`` (port of ``neutfem_tpu/parallel.py``).

The JAX package decomposes the structured grid over a 1D or 2D device mesh
and lets GSPMD partition one jitted power iteration.  Here the same
decomposition is an explicit SPMD program: one process per rank, each
holding its slab of the mesh, running ``power.power_iteration`` eagerly
under a ``shardctx.sharding_scope``; the halos and sums GSPMD inserted are
written out:

* a direction orthogonal to every cut runs its kernel (K1-K3, K6, K4 in
  ``compute_current``) on the rank's complete local lines;
* the direction along a cut runs the partitioned solve
  (``ops/parttri.py``: K4 on each segment, one all-gather of the segments'
  first and last planes, one plane to each neighbour) where the JAX package
  does; where it takes its associative scan instead — a PERIODIC cut
  direction, a segment of one face, ``NEUTFEM_PARTTRI=0`` — the scan solve
  (``ops/parttri.tridiag_solve_scan``: each rank's faces composed at log
  depth, one all-gather of the composed end planes a sweep);
* every dot product of the CG and every sum of the power iteration is
  all-reduced, so every rank takes the same branch.

Decomposition: a 1D mesh ("space") cuts one grid axis (y by default, z for
tall 3D problems); a 2D mesh ("space_z", "space_y") cuts z and y.  Each rank
holds an even slab: n/p cells along a cut axis (p must divide n, as the JAX
package's ``shard_state`` requires; one cell a rank is allowed), and, of the
cut direction's n+1 faces, the n/p body faces of its cells plus the seam
face n, which every rank holds (``__seam``); a PERIODIC cut direction's
folded system has n faces and no seam.  The rank's context is sliced from the HOST context
(``ops/context.build_host_context``), so no device holds the whole problem.

The transport is the backend the caller names (``device_mesh``): "nccl" for
tensors on the card, "gloo" for CPU tensors or CUDA tensors staged through
the host (two ranks sharing one card).  Nothing falls back to another.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .fespace import GRID_AXIS, FESpace
from .ops.context import context_to_device, stage_operands
from .ops.parttri import build_partitioned
from .power import SolveOptions, power_iteration
from .shardctx import Transport, gather_slabs, sharding_scope

__all__ = ["Mesh", "device_mesh", "shard_context", "shard_state", "gather_state",
           "sharded_power_iteration", "spawn_ranks", "SPATIAL_AXIS", "SPATIAL_AXES_2D"]

#: mesh axis names; a 1D mesh uses the first, a 2D mesh both ((z, y) order)
SPATIAL_AXIS = "space"
SPATIAL_AXES_2D = ("space_z", "space_y")

GridAxes = Union[int, Sequence[int]]

#: context keys of the staged kernel operands, remade from each rank's slab
_STAGED_PREFIXES = ("tri_xT_", "tri_yT_", "tri_hoyT_", "tri_hoxT_")
#: the fused kernels' operand of a direction, unused where its axis is cut
_FUSED_PREFIXES = ("tri_dinvm_",)
#: face arrays (n + 1 along their own axis) split along a cut into the rank's
#: body and the seam face (``<key>__seam``), as the JAX package splits them
_SPLIT_PREFIXES = ("tri_dinv_", "mask_", "dtilde_", "jscale_")
#: kept whole on every rank: the dense Schur factors (``ops/direct.py``),
#: which the JAX package replicates (``neutfem_tpu/parallel.py:85``)
_WHOLE_PREFIXES = ("schur_",)


class Mesh:
    """The ranks as a device mesh: ``dmesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``), its axis names and sizes,
    this rank's coordinate on each axis, one ``shardctx.Transport`` per axis
    (``axes``) and one over every rank (``world``)."""

    def __init__(self, dmesh, backend: str):
        import torch.distributed as dist

        self.dmesh, self.backend = dmesh, backend
        self.axis_names = tuple(dmesh.mesh_dim_names)
        self.sizes = dict(zip(self.axis_names, dmesh.mesh.shape))
        self.coords = {nm: dmesh.get_local_rank(nm) for nm in self.axis_names}
        self.axes = {nm: Transport(dmesh.get_group(nm), backend) for nm in self.axis_names}
        self.world = Transport(dist.group.WORLD, backend)

    def __repr__(self):
        return f"Mesh({self.sizes}, backend={self.backend!r}, coords={self.coords})"


def device_mesh(backend: str, shape: Optional[Tuple[int, int]] = None, *,
                init_method: Optional[str] = None, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Mesh:
    """The mesh of every rank over ``backend`` ("nccl" or "gloo", named by
    the caller): 1D by default, 2D ((z, y)) when ``shape`` (a 2-tuple whose
    product is the world size) is given.  Starts the process group from
    ``init_method`` (e.g. ``tcp://localhost:<port>`` or ``file://<path>``),
    ``rank`` and ``world_size`` unless one is running, which must then run
    ``backend``.  For "nccl" the rank's card is rank % the cards here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("device_mesh: no process group runs; give init_method, rank "
                             "and world_size")
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("device_mesh: backend 'nccl' needs a CUDA device")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"device_mesh: the running process group is {dist.get_backend()!r}, "
                           f"the caller asked for {backend!r}")
    world = dist.get_world_size()
    if shape is None:
        shape, names = (world,), (SPATIAL_AXIS,)
    else:
        shape, names = tuple(int(s) for s in shape), SPATIAL_AXES_2D
        if len(shape) != 2 or shape[0] * shape[1] != world:
            raise ValueError(f"device_mesh: shape {shape} does not hold {world} ranks")
    dmesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                             mesh_dim_names=names)
    return Mesh(dmesh, backend)


def _axis_map(mesh: Mesh, grid_axis: GridAxes) -> Dict[int, str]:
    """{spatial grid axis (0=nz, 1=ny, 2=nx) -> mesh axis name}."""
    if isinstance(grid_axis, int):
        if len(mesh.axis_names) != 1:
            raise ValueError("a 2D mesh needs two grid axes")
        return {grid_axis: mesh.axis_names[0]}
    gas = list(grid_axis)
    if len(gas) != len(mesh.axis_names):
        raise ValueError(f"grid axes {gas} against mesh axes {mesh.axis_names}")
    return {ga: nm for ga, nm in zip(gas, mesh.axis_names)}


def _cuts(mesh: Mesh, amap: Dict[int, str], shape) -> Dict[int, Tuple[int, int, int]]:
    """{cut grid axis: (cells n, parts p, this rank's part k)}.  Raises
    ``ValueError`` where p does not divide n: every rank holds an even slab,
    as the JAX package's ``shard_state`` (``jax.device_put``) requires."""
    out = {}
    for ga, nm in amap.items():
        n, p = int(shape[ga]), mesh.sizes[nm]
        if n % p:
            raise ValueError(f"grid axis {ga} ({n} cells) over {p} ranks: each rank holds an "
                             f"even slab of n/p cells, so p must divide n")
        out[ga] = (n, p, mesh.coords[nm])
    return out


def _take(a, ax: int, lo: int, hi: int):
    idx = [slice(None)] * a.ndim
    idx[ax] = slice(lo, hi)
    return a[tuple(idx)]


def _slab(a, cuts, base: int, own: Optional[int] = None, split: bool = False):
    """The rank's slab of a host array whose spatial (nz, ny, nx) dims start
    at ``base``: cell dims (n along a cut) give the rank's s = n/p cells;
    along ``own`` (the array's own direction, n+1 faces) ``split`` gives the
    s body faces and returns the seam face apart, else the s+1 faces of the
    slab.  Unit dims broadcast.  Returns (slab, seam or None)."""
    seam, faces = None, False
    if own is not None and own in cuts and a.shape[base + own] == cuts[own][0] + 1:
        n, p, k = cuts[own]
        s, ax = n // p, base + own
        if split:
            seam = _take(a, ax, n, n + 1)
        a = _take(a, ax, k * s, k * s + s + (0 if split else 1))
        faces = True
    for ga, (n, p, k) in cuts.items():
        if ga == own and faces or a.shape[base + ga] == 1:
            continue  # the faces of the slab, taken above; a unit dim
        if a.shape[base + ga] != n:
            raise ValueError(f"shard: a dim of {a.shape[base + ga]} along cut grid axis {ga} "
                             f"({n} cells)")
        s = n // p
        a = _take(a, base + ga, k * s, k * s + s)
        if seam is not None:
            seam = _take(seam, base + ga, k * s, k * s + s)
    return np.ascontiguousarray(a), (None if seam is None else np.ascontiguousarray(seam))


def _direction_axis(key: str) -> Optional[int]:
    """The grid axis of a context key's direction (its ``_d{d}`` suffix)."""
    suffix = key.rsplit("_", 1)[-1]
    if len(suffix) == 2 and suffix[0] == "d" and suffix[1].isdigit():
        return GRID_AXIS[int(suffix[1])]
    return None


def shard_context(host, mesh: Mesh, fes: FESpace, grid_axis: GridAxes = 1, *, device,
                  dtype) -> Dict[str, torch.Tensor]:
    """This rank's operator context on ``device``, sliced from the host
    context ``host`` = ``ops.context.build_host_context(...)`` (the whole
    problem's arrays, numpy float64, and its block-Jacobi ingredients):

    * every spatial array keeps the rank's slab; the cut direction's face
      arrays of ``_SPLIT_PREFIXES`` are split into the rank's body faces and
      the seam face (``__seam``), its other face arrays keep the slab's s+1
      faces; ``tri_part_*_{key}``: the partitioned solve's bundle of each cut
      direction (``ops/parttri.build_partitioned`` on the whole factors,
      then sliced: ``l`` with its s-1 couplings, ``minv`` with its line dims
      cut only by the other axis of a 2D mesh); under "diag" / "lumped"
      (no ``tri_l``) the cut direction's ``tri_dinv`` is split the same way
      and has no bundle (``ops/parttri.partitioned_face_solve`` multiplies
      by it);
    * the dense Schur factors ``schur_*`` of the DIRECT_* solver (put on
      the host context by the caller: ``ops/direct.attach_dense_schur`` on
      the whole problem) are kept whole on every rank: each rank solves the
      whole system (``ops/direct.direct_solve``);
    * the staged operands of the directions along no cut (``tri_xT_*``,
      ``tri_yT_*``, ``tri_hoyT_*``, ``tri_hoxT_*``) are restaged from the
      slab (``ops/context.stage_operands``), so K2 / K3 and K6 run on the
      rank's complete local lines.  The JAX package instead drops them and
      runs the unstaged kernels per shard (``neutfem_tpu/ops/apply.py:363``);
      both give the same numbers to rounding;
    * the two-grid level, the cut direction's fused operands and the line
      preconditioner's factors along a cut are dropped (none runs there);
    * the block-Jacobi ingredients' cell planes keep the rank's slab; its
      blocks are built and inverted on ``device``, and their storage decision
      (max|E| against e4m3's saturation) is reduced over every rank
      (``mesh.world``), so it stays the whole context's.

    The cut direction's solve is chosen here, by the JAX rule: an exact A
    gets the partitioned bundle unless the direction is PERIODIC, a segment
    would hold one face (n = p) or ``NEUTFEM_PARTTRI=0``; without a bundle
    it keeps its ``tri_dinv`` / ``tri_l`` slab (the body couplings, and
    ``tri_l_{key}__prev``: the coupling into the slab's first face, 0 on
    rank 0) for the scan solve.  A PERIODIC cut direction keeps its folded
    factors (n faces, no seam; ``tri_l`` padded with a 0 past its last
    face), ``cyc_wt`` slab and ``cyc_a0`` / ``cyc_a1`` per line, and drops
    its T-staged ``tri_cycT_*`` factors.  Raises ``ValueError`` where p does
    not divide n (``_cuts``)."""
    ctx_np, blk = host
    amap = _axis_map(mesh, grid_axis)
    cuts = _cuts(mesh, amap, fes.mesh.shape)
    cut_keys = {f"d{di.d}": di.axis for di in fes.dirs if di.axis in amap}
    partition = os.environ.get("NEUTFEM_PARTTRI", "1") != "0"
    arrays, scan = dict(ctx_np), {}
    for key, ga in cut_keys.items():
        if f"tri_l_{key}" not in ctx_np:
            continue  # "diag" / "lumped": the elementwise cut solve needs no bundle
        bundle = None
        if partition and f"cyc_wt_{key}" not in ctx_np:
            bundle = build_partitioned(ctx_np[f"tri_dinv_{key}"], ctx_np[f"tri_l_{key}"],
                                       1 + ga, cuts[ga][1])  # None where n // p < 2
        if bundle is not None:
            arrays.update({f"tri_part_{nm}_{key}": a for nm, a in bundle.items()})
            continue
        l = np.asarray(ctx_np[f"tri_l_{key}"])
        fax = l.ndim - 3 + ga
        if l.shape[fax] < cuts[ga][0]:  # PERIODIC: n-1 couplings of n faces
            l = np.concatenate([l, np.zeros_like(_take(l, fax, 0, 1))], axis=fax)
        arrays[f"tri_l_{key}"] = l
        # face j's incoming coupling l_{j-1} (0 for face 0), sliced below to
        # the slab's first face
        scan[key] = np.concatenate([np.zeros_like(_take(l, fax, 0, 1)),
                                    _take(l, fax, 0, l.shape[fax] - 1)], axis=fax)
    pc_dirs = sorted((di.d for di in fes.dirs), reverse=True)
    line_cut = {name for name, d in zip(("line", "line2"), pc_dirs) if GRID_AXIS[d] in amap}

    local = {}
    for k, v in arrays.items():
        own = _direction_axis(k)
        if isinstance(v, dict) or k.startswith(_STAGED_PREFIXES):
            continue  # the two-grid level declines; the staged operands are remade
        if own in amap and k.startswith(_FUSED_PREFIXES + ("tri_cycT_",)):
            continue
        if k.startswith("precond_line") and k.split("_")[1] in line_cut:
            continue
        v = np.asarray(v)
        if k.startswith(_WHOLE_PREFIXES):
            local[k] = v
            continue
        if k.startswith("tri_part_minv_"):
            local[k] = _minv_slab(v, cuts, own)
            continue
        base = v.ndim - 3
        if v.ndim < 3:
            local[k] = v
            continue
        body, seam = _slab(v, cuts, base, own, split=k.startswith(_SPLIT_PREFIXES))
        if k.startswith("tri_part_l_"):  # the segment's s-1 couplings
            body = np.ascontiguousarray(_take(body, base + own, 0, body.shape[base + own] - 1))
        local[k] = body
        if seam is not None:
            local[k + "__seam"] = seam
    for key, prev in scan.items():
        body, _ = _slab(prev, cuts, prev.ndim - 3)
        local[f"tri_l_{key}__prev"] = np.ascontiguousarray(
            _take(body, prev.ndim - 3 + cut_keys[key], 0, 1))
    for di in fes.dirs:
        key = f"d{di.d}"
        if f"tri_dinvm_{key}" in local and di.axis in (1, 2):
            stage_operands(local, key, di.axis, fes.et.k > 0)
    if blk is not None:
        blk = {k: v if v.ndim < 3 else _slab(v, cuts, v.ndim - 3)[0] for k, v in blk.items()}
    return context_to_device(local, blk, fes.P, device, dtype, world=mesh.world)


def _minv_slab(minv: np.ndarray, cuts, own: int) -> np.ndarray:
    """The rank's ``minv`` (batch..., l1, l2, 2p, 2p): its line dims are the
    spatial dims without the cut axis ``own``; the other axis of a 2D mesh
    cuts its line dim, the interface block is whole on every rank."""
    lines = [g for g in (0, 1, 2) if g != own]
    for i, g in enumerate(lines):
        if g in cuts:
            n, p, k = cuts[g]
            minv = _take(minv, minv.ndim - 4 + i, k * (n // p), (k + 1) * (n // p))
    return np.ascontiguousarray(minv)


def shard_state(phi, mesh: Mesh, grid_axis: GridAxes = 1, *, device=None):
    """This rank's slab of a flux (ng, nz, ny, nx, P) (a tensor or numpy
    array of the whole problem), as a contiguous tensor on ``device`` (the
    tensor's own device by default).  Raises ``ValueError`` where p does
    not divide n."""
    amap = _axis_map(mesh, grid_axis)
    a = phi.detach().cpu().numpy() if torch.is_tensor(phi) else np.asarray(phi)
    cuts = _cuts(mesh, amap, a.shape[1:4])
    dev = device if device is not None else (phi.device if torch.is_tensor(phi) else "cpu")
    dtype = phi.dtype if torch.is_tensor(phi) else torch.float64
    return torch.as_tensor(_slab(a, cuts, 1)[0], dtype=dtype, device=dev)


def gather_state(x, mesh: Mesh, grid_axis: GridAxes = 1, *, base: int = 1,
                 face_axis: Optional[int] = None):
    """The whole problem's array from every rank's slab ``x`` (the
    counterpart of ``np.asarray`` on a sharded JAX array), on every rank: its
    spatial (nz, ny, nx) dims start at ``base`` (1 for a flux (ng, nz, ny,
    nx, P) or a current's "face" / "bub" entry).  ``face_axis``: the grid
    axis along which ``x`` holds faces (a face current); along a cut each
    rank then holds its slab's s+1 faces, and the slab's last face is the
    next one's first."""
    return gather_slabs(x, mesh, _axis_map(mesh, grid_axis), base, face_axis)


def sharded_power_iteration(fes: FESpace, ng: int, opts: SolveOptions, mesh: Mesh,
                            grid_axis: GridAxes = 1):
    """The power iteration of one rank's slab.  Returns (run, axis_map):
    ``run(ctx, phi0, keff0, adjoint=False)`` takes the
    rank's context (``shard_context``) and flux slab (``shard_state``) and
    returns ``power.power_iteration``'s result with the rank's flux and
    current (``gather_state`` assembles them), plus ``"sharding"``: the
    backend, the mesh, and how the CG loop ran ("graph" replays, or the
    "eager" block loop where the transport cannot be captured).  Every rank
    must call ``run`` with the same options: the collectives pair up in
    order."""
    amap = _axis_map(mesh, grid_axis)
    _cuts(mesh, amap, fes.mesh.shape)

    def run(ctx, phi0, keff0, adjoint: bool = False):
        with sharding_scope(mesh, amap):
            res = power_iteration(fes, ng, opts, ctx, phi0, keff0, adjoint=adjoint)
        on_card = phi0.device.type == "cuda"
        res["sharding"] = {"backend": mesh.backend, "mesh": dict(mesh.sizes),
                           "axis_map": dict(amap),
                           "cg": ("graph" if mesh.world.capturable else "eager") if on_card
                           else "eager"}
        return res

    return run, amap


def spawn_ranks(target, world: int, init: str, args, timeout: float):
    """Run ``target(rank, world, init, args)`` (a picklable top-level
    function that starts its process group from ``init``) on ``world`` ranks,
    each a spawned process, and return their results in rank order.  A rank
    that fails, or no result from every rank within ``timeout`` seconds,
    kills every rank and raises; each rank's process group is destroyed when
    its target returns."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, init, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, payload = q.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise RuntimeError(f"{target.__name__} on {world} ranks: no result within "
                                   f"{timeout} s")
            if status != "ok":
                raise RuntimeError(f"{target.__name__}: rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [results[r] for r in range(world)]


def _rank_entry(target, rank, world, init, args, q):
    """A spawned rank of ``spawn_ranks``: (rank, "ok", result) or (rank,
    "error", traceback) on ``q``."""
    import torch.distributed as dist

    try:
        q.put((rank, "ok", target(rank, world, init, args)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
