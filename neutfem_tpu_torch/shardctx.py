"""Run-time sharding scope and the collectives of the multi-device solve.

Port of ``neutfem_tpu/shardctx.py``.  The JAX package traces its power
iteration once under ``jit`` with a sharding scope active, and GSPMD inserts
every halo exchange and sum.  Here each process (rank) runs its own slab of
the mesh eagerly: the scope is consulted at RUN time, by the operator layer
(``ops/apply.py``: a cut direction takes the partitioned or the scan solve
of ``ops/parttri.py``, every other direction its kernel on the rank's
complete local lines), by the CG (``krylov``: every dot product is summed over the
ranks) and by the power iteration (its global sums).  With no scope active
none of them runs a collective.

``Transport`` is the collectives of one process group, over the backend the
caller named:

* ``"nccl"``: device tensors on the card; capturable in a CUDA graph (the CG's
  blocks replay their collectives);
* ``"gloo"``: CPU tensors (the CPU tests), or CUDA tensors staged through host
  memory — for two ranks sharing one card, which NCCL does not allow.  A
  staged collective copies to the host and back, so it cannot be captured:
  the CG then runs its eager block loop (``Transport.capturable``).

Nothing picks a backend by itself: a tensor a transport does not take raises.
``tracing``'s ``comm.collectives``, ``comm.comm_bytes`` and
``comm.staged_bytes`` count the collectives, their payload bytes and the
bytes staged through the host (a graph replay counts what its capture ran).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from . import tracing

__all__ = ["sharding_scope", "no_sharding", "current_sharding", "cut_transport", "Transport",
           "allsum", "all_ranks", "halo", "seam_faces", "gather_slabs", "take_slab"]

_CURRENT: Optional[Tuple[object, Dict[int, str]]] = None


@contextlib.contextmanager
def sharding_scope(mesh, axis_map: Dict[int, str]):
    """axis_map: spatial grid axis (0=nz, 1=ny, 2=nx) -> mesh axis name;
    ``mesh``: a ``parallel.Mesh``."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = (mesh, dict(axis_map))
    try:
        yield
    finally:
        _CURRENT = prev


@contextlib.contextmanager
def no_sharding():
    """Suspend the active scope: what runs inside is a whole problem on
    this rank alone, with no collective (``coarse.coarse_init``'s coarse
    solve)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = None
    try:
        yield
    finally:
        _CURRENT = prev


def current_sharding() -> Optional[Tuple[object, Dict[int, str]]]:
    """(mesh, axis_map) of the active scope, or None."""
    return _CURRENT


def cut_transport(grid_axis: int) -> Optional["Transport"]:
    """The transport of the mesh axis that cuts spatial grid axis
    ``grid_axis`` (0=nz, 1=ny, 2=nx) under the active scope, or None (no
    scope, or that axis is not cut)."""
    if _CURRENT is None or grid_axis not in _CURRENT[1]:
        return None
    mesh, amap = _CURRENT
    return mesh.axes[amap[grid_axis]]


def allsum(*ts):
    """The sums over every rank of the local sums ``ts``: the tensors
    themselves with no scope active, else one all-reduce over the mesh's
    world for all of them (0-d tensors stacked, others packed flat).
    Returns a tensor for one argument, a tuple for several."""
    if _CURRENT is None:
        return ts[0] if len(ts) == 1 else ts
    world = _CURRENT[0].world
    if len(ts) == 1:
        return world.all_sum(ts[0])
    if all(t.dim() == 0 for t in ts):
        return tuple(world.all_sum(torch.stack(ts)).unbind())
    flat = world.all_sum(torch.cat([t.reshape(-1) for t in ts]))
    return tuple(part.reshape(t.shape) for part, t in zip(flat.split([t.numel() for t in ts]),
                                                           ts))


def all_ranks(flag):
    """A 0-d bool tensor that holds on every rank iff ``flag`` holds on every
    rank (one all-reduce under a scope; ``flag`` itself otherwise), so every
    rank takes the same branch on it."""
    if _CURRENT is None:
        return flag
    return allsum((~flag).to(torch.float32)) == 0


def halo(x, ax: int, tr: "Transport", cyclic: bool = False):
    """(lo, hi): the previous rank's last plane and the next rank's first
    plane of ``x`` along tensor axis ``ax`` (a cut axis, ``tr`` its
    transport), zeros at the domain's ends, or with ``cyclic`` (a PERIODIC
    direction) the planes of the other end; two point-to-point exchanges."""
    n = x.shape[ax]
    return (tr.shift(x.narrow(ax, n - 1, 1), +1, cyclic),
            tr.shift(x.narrow(ax, 0, 1), -1, cyclic))


def seam_faces(body, seam, ax: int, tr: "Transport", cyclic: bool = False):
    """The s+1 faces of a rank's slab of a face array split into body and
    seam (``parallel.shard_context``): its s body faces along tensor axis
    ``ax``, then the face that closes the slab — the next rank's first body
    face (one plane sent), or on the last rank the seam face; with
    ``cyclic`` (a PERIODIC direction, whose face n is face 0, no seam: pass
    None) the last rank's is rank 0's first face."""
    nxt = tr.shift(body.narrow(ax, 0, 1), -1, cyclic)
    return torch.cat([body, seam if tr.rank == tr.size - 1 and not cyclic else nxt], dim=ax)


def gather_slabs(x, mesh, amap: Dict[int, str], base: int, face_axis: Optional[int] = None):
    """The whole problem's array from every rank's slab ``x`` (one
    all-gather over the world), on every rank: its spatial (nz, ny, nx)
    dims start at ``base``; ``face_axis``: the grid axis along which ``x``
    holds the s+1 faces of its slab (the slab's last face is the next one's
    first)."""
    g = mesh.world.all_gather(x)
    ga_of = {nm: ga for ga, nm in amap.items()}

    def join(ranks, level):
        if level == len(mesh.axis_names):
            return g[int(ranks)]
        ga = ga_of[mesh.axis_names[level]]
        parts = [join(ranks[i], level + 1) for i in range(ranks.shape[0])]
        if ga == face_axis:
            s = parts[0].shape[base + ga] - 1
            parts = [p.narrow(base + ga, 0, s) for p in parts[:-1]] + parts[-1:]
        return torch.cat(parts, dim=base + ga)

    return join(mesh.dmesh.mesh, 0)


def take_slab(x, mesh, amap: Dict[int, str], base: int):
    """This rank's even slab of a whole problem's cell array ``x`` (spatial
    dims from ``base``), contiguous."""
    for ga, nm in amap.items():
        s = x.shape[base + ga] // mesh.sizes[nm]
        x = x.narrow(base + ga, mesh.coords[nm] * s, s)
    return x.contiguous()


class Transport:
    """The collectives of one process group (``group``: a
    ``torch.distributed`` group, ``backend``: the one the caller named).
    ``rank`` / ``size`` are this process's place in the group and its size."""

    def __init__(self, group, backend: str):
        import torch.distributed as dist

        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
        actual = dist.get_backend(group)
        if actual != backend:
            raise RuntimeError(f"the process group runs {actual!r}, the caller asked for "
                               f"{backend!r}")
        self.group, self.backend = group, backend
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self._ranks = dist.get_process_group_ranks(group)

    @property
    def capturable(self) -> bool:
        """True where the collectives may run inside a captured CUDA graph:
        NCCL on device tensors.  Gloo stages CUDA tensors through the host."""
        return self.backend == "nccl"

    def _wire(self, t):
        """``t`` as the backend takes it (contiguous; a CUDA tensor copied to
        the host for gloo), counted."""
        if self.backend == "nccl" and t.device.type != "cuda":
            raise RuntimeError(f"nccl transport: a {t.device.type} tensor; the caller asked for "
                               "nccl, which takes device tensors only")
        t = t.contiguous()
        tracing.count("comm.collectives")
        tracing.count("comm.comm_bytes", t.numel() * t.element_size())
        if self.backend == "gloo" and t.device.type == "cuda":
            tracing.count("comm.staged_bytes", t.numel() * t.element_size())
            return t.cpu()
        return t

    def _back(self, h, like):
        if h.device != like.device:
            tracing.count("comm.staged_bytes", h.numel() * h.element_size())
            return h.to(like.device)
        return h

    def _all_reduce(self, t, op):
        import torch.distributed as dist

        w = self._wire(t)
        w = w.clone() if w is t else w
        dist.all_reduce(w, op=getattr(dist.ReduceOp, op), group=self.group)
        return self._back(w, t)

    def all_sum(self, t):
        """The sum of ``t`` over the group (a new tensor)."""
        return self._all_reduce(t, "SUM")

    def all_max(self, t):
        """The elementwise largest ``t`` over the group (a new tensor)."""
        return self._all_reduce(t, "MAX")

    def all_gather(self, t):
        """(size, *t.shape): every rank's ``t`` in group-rank order."""
        import torch.distributed as dist

        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(out, w, group=self.group)
        return self._back(torch.stack(out), t)

    def shift(self, t, step: int, cyclic: bool = False):
        """The ``t`` of group rank ``rank - step`` (step +1: from the previous
        rank; -1: from the next), zeros where that rank does not exist; with
        ``cyclic`` the ranks form a ring (rank 0's previous is the last
        rank; a group of one receives its own ``t``).  One point-to-point
        send and receive per rank."""
        import torch.distributed as dist

        src, dst = self.rank - step, self.rank + step
        if cyclic:
            if self.size == 1:
                return t.clone()
            src, dst = src % self.size, dst % self.size
        have_src, have_dst = 0 <= src < self.size, 0 <= dst < self.size
        if not (have_src or have_dst):
            return torch.zeros_like(t)
        ops = []
        if have_dst:
            ops.append(dist.P2POp(dist.isend, self._wire(t), self._ranks[dst], group=self.group))
        got = torch.zeros(t.shape, dtype=t.dtype,
                          device="cpu" if self.backend == "gloo" else t.device)
        if have_src:
            ops.append(dist.P2POp(dist.irecv, got, self._ranks[src], group=self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(got, t)
