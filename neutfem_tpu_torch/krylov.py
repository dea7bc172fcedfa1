"""Krylov solvers (port of ``neutfem_tpu/krylov.py``: ``pcg``, ``pcg_fused``, ``bicgstab``).

The JAX package runs each solve as one ``lax.while_loop`` on the device.
Here the loop runs in blocks of iterations with one host read per block: each
iteration computes the JAX loop's condition on the device,

    go = go_prev & (it < maxiter) & (rr > tol_sq) & ~breakdown & ~zero_rhs,

and once ``go`` is false the iterations that follow are no-ops on the state the
result is read from (the CG's alpha and beta, BiCGSTAB's beta, alpha and
omega are masked to 0, so x + 0 p == x; rr and the count are selected back),
so the iterates and the iteration count — a parity observable — are the
``while_loop``'s whatever the block size.
After each block the host reads one small tensor, (it, go), and starts the
next block only while ``go`` holds.  Stopping rule of the reference:
``||r||^2 < tol^2 ||b||^2`` (solvers.cpp:592, 620).

* On a CUDA tensor ``pcg`` / ``pcg_fused`` / ``bicgstab`` replay a block of ``BLOCK_ITERS``
  iterations captured once as a ``torch.cuda.CUDAGraph`` (``CGGraph``): a solve
  of n iterations costs ceil(n / BLOCK_ITERS) host reads (at least one) and
  as many replays.  The prologue (r0 = rhs - A x0, the first preconditioner
  apply and the stop test's operands) runs eagerly and is copied into the
  graph's static state.  A capture that fails raises; there is no other loop.
* ``pcg_blocks`` / ``pcg_fused_blocks`` / ``bicgstab_blocks`` are the same
  block loop run eagerly (any device): on a CPU tensor the solvers run it with one
  iteration a block, as a host read costs nothing there; on the card it is
  what the graph is held against.

The three recurrences:

* ``pcg``: the textbook loop; ``precond_dots`` takes a fused preconditioner
  ``r -> (z, <r, z>, <r, r>)`` (the K8 block-Jacobi kernel, ``ops/blockjac.py``).
  Its step's elementwise and 0-d work (the masked alpha and beta, the x, r
  and p updates, the next state) is ``ops/cgstep``'s two kernels on the
  card, bit for bit the PyTorch expressions they run on the CPU.
* ``pcg_fused``: the Chronopoulos-Gear single-reduction recurrence, selected by
  ``power.group_solve`` under ``NEUTFEM_CGCG=1`` (opt-in, as in the JAX
  package).  Its dot products are separate ``torch.sum`` reductions here: the
  port has no fused multi-result reduction, so it keeps the recurrence and
  the iteration counts, not the JAX package's one-reduction kernel.
* ``bicgstab``: right-preconditioned BiCGSTAB, the JAX body's operations in
  its order; taken by ``power.group_solve`` under ``inner_solver="bicgstab"``
  and by CMFD's "wielandt" low-order eigensolve (``cmfd.py``).

Tracing (``tracing.py``): the spans ``neutfem.cg.prologue`` (the eager
prologue, a capture where one is due, the copy into the graph's static
state), ``neutfem.cg.capture`` and ``neutfem.cg.replay`` (each
``graph.replay()``), the synchronisation sites ``cg_read`` (the host read of
a block) and ``capture`` (entering a capture, which synchronizes the
device), and the counters ``cg.solves``, ``cg.iterations`` (the solves'
live iterations), ``cg.iterations_run`` (what the blocks launched:
BLOCK_ITERS a replay, the eager block size a read), ``cg.host_reads``,
``cg.replays``, ``cg.captures`` and ``cg.eager_solves``.  Whatever the
captured step counts (``tracing.count`` in a kernel wrapper, a collective,
a preconditioner: ``fused.z_rows``, ``comm.collectives``,
``precond.line_applies``, ...) a replay counts again: ``CGGraph`` takes back
what its capture counted and adds it at each replay, frozen iterations
included (a block runs its step BLOCK_ITERS times whether or not ``go``
still holds).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import tracing
from .ops import cgstep
from .shardctx import allsum, current_sharding

__all__ = ["pcg", "pcg_fused", "pcg_blocks", "pcg_fused_blocks", "bicgstab",
           "bicgstab_blocks", "CGGraph", "CGPlans", "CG_PLANS", "drop_plans", "KrylovResult",
           "BLOCK_ITERS"]

#: Iterations per block (per host read) of a CG on a CUDA tensor: the
#: captured graph holds this many iterations.  Swept on an H100 over 4, 8, 16
#: and 32, one process per value (PERF.md §6): at 4 the busier RT2-P2
#: and IAEA-3D 8x8x8 paths run 7-8% faster than at 8 (the frozen tail), the
#: host-bound RT0 7% slower, ZION within its spread; 16 and 32 lose on all.
BLOCK_ITERS = 4

#: The blocks' span names (``tracing``).
PROLOGUE, REPLAY, CAPTURE = "neutfem.cg.prologue", "neutfem.cg.replay", "neutfem.cg.capture"


def _dot(a, b):
    """<a, b>: summed over the ranks under a sharding scope (``shardctx``),
    so every rank reads the same stop test."""
    return allsum(torch.sum(a * b))


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # ||r|| / ||b||


def _status(st) -> torch.Tensor:
    return torch.stack((st["it"], st["go"].to(st["it"].dtype)))


def _read(status):
    """The one host read of a block: (iterations, go)."""
    with tracing.sync("cg_read"):
        it, go = status.tolist()
    tracing.count("cg.host_reads")
    return it, bool(go)


#: The context entry that holds its CG plans (``CGPlans``); set on a context
#: on the card by ``power.power_iteration``.
CG_PLANS = "cg_plans"


class CGPlans:
    """The CG plans of one context (``ctx[CG_PLANS]``), freed with it: each
    plan holds a solve's operator and preconditioner, every tensor they close
    over made once, and the ``CGGraph`` its iterations replay (keys and plans
    are the caller's: ``power.group_plan``, ``cmfd``).  ``buffers`` are
    static tensors that plans share and refill before each solve.  Not a
    dict, so ``power.ctx_group`` passes it to every group's context as it
    is."""

    def __init__(self):
        self.plans: Dict = {}
        self.buffers: Dict = {}

    def buffer(self, shape, dtype, device) -> torch.Tensor:
        """The shared static buffer of this shape and dtype, made at first use."""
        key = (tuple(shape), dtype, device)
        if key not in self.buffers:
            self.buffers[key] = torch.empty(shape, dtype=dtype, device=device)
        return self.buffers[key]


def drop_plans(ctx: Dict) -> None:
    """Forget the context's CG plans: to be called by whatever replaces an
    entry of the context that a plan may close over (a replay would run the
    old one)."""
    ctx.pop(CG_PLANS, None)


_WARMUP: Dict[int, torch.cuda.Stream] = {}


def _warmup_stream() -> torch.cuda.Stream:
    """The side stream of every capture's warm-up on the current device, one
    a device: cuBLAS keeps a workspace per stream it ran on for the life of
    the process, so a new stream a capture would keep one more each time."""
    dev = torch.cuda.current_device()
    if dev not in _WARMUP:
        _WARMUP[dev] = torch.cuda.Stream(dev)
    return _WARMUP[dev]


class CGGraph:
    """One CG's block of iterations captured as a CUDA graph, with the static
    state it runs on.  A caller that solves the same system repeatedly
    (``power.group_solve``: one per context, group and path) keeps one and
    passes it to every solve, so the capture is made once; the operator and
    preconditioner must then be the same callables, closing over tensors that
    outlive the graph, each time (a replay runs what was captured).  The
    capture is made again where the state's shapes, dtypes, the block size or
    ``maxiter`` change.

    The counters (``tracing``): the capture runs nothing, so what its step
    counted while it was captured is taken back and added again at every
    replay; the warm-up step before it ran, and counts once."""

    def __init__(self):
        self.graph = None
        self.sig = None
        self.state: Dict[str, torch.Tensor] = {}
        self.status = None
        self.counted: Dict[str, int] = {}

    def load(self, step, st0, k: int, maxiter: int):
        """Capture blocks of ``k`` iterations of ``step`` (which stops at
        ``maxiter``) where no capture of this signature is held, then copy
        the prologue's state ``st0`` into the static state."""
        sig = (k, maxiter, *((n, tuple(t.shape), t.dtype) for n, t in st0.items()))
        if self.graph is None or sig != self.sig:
            with tracing.span(CAPTURE):
                self._capture(step, st0, k)
            self.sig = sig
        for n, t in st0.items():
            self.state[n].copy_(t)

    def replay(self):
        """Replay the loaded blocks until the stop test fails.  Returns (the
        static state, iterations)."""
        k = self.sig[0]
        while True:
            with tracing.span(REPLAY):
                self.graph.replay()
            tracing.count("cg.replays")
            tracing.count("cg.iterations_run", k)
            for name, n in self.counted.items():
                tracing.count(name, n)
            it, go = _read(self.status)
            if not go:
                break
        return self.state, it

    def _capture(self, step, st0, k: int):
        self.graph = None
        self.state = {n: t.clone() for n, t in st0.items()}
        # warm-up on a side stream, as capture requires (library build, cuBLAS
        # handles); step is functional, so the state is not touched
        side = _warmup_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(dict(self.state))
        torch.cuda.current_stream().wait_stream(side)
        before = tracing.totals()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a graph it frees (a dropped
        # plan's, held in a reference cycle) is destroyed inside the capture,
        # which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with contextlib.ExitStack() as capture:
                # entering the capture synchronizes the device first
                with tracing.sync("capture"):
                    capture.enter_context(torch.cuda.graph(graph))
                st = dict(self.state)
                for _ in range(k):
                    st = step(st)
                for n, t in st.items():
                    if t is not self.state[n]:
                        self.state[n].copy_(t)
                self.status = _status(self.state)
        finally:
            if collecting:
                gc.enable()
        self.counted = {name: n - before.get(name, 0) for name, n in tracing.totals().items()
                        if n != before.get(name, 0)}
        for name, n in self.counted.items():
            tracing.count(name, -n)
        self.graph = graph
        tracing.count("cg.captures")


def _run(parts, graph: Optional[CGGraph], block: Optional[int], maxiter: int):
    """The block loop of the solve whose prologue ``parts()`` makes (state,
    step, <b, b>, zero rhs): ``block`` iterations (eager) or one replay of
    ``graph`` per host read.  Returns (final state, iterations, <b, b>, zero rhs)."""
    tracing.count("cg.solves")
    with tracing.span(PROLOGUE):
        st0, step, b_norm_sq, zero_rhs = parts()
        if block is None:
            sh = current_sharding()
            if st0["x"].device.type == "cuda" and sh is not None and not sh[0].world.capturable:
                # a host-staged transport (gloo on the card) cannot be captured:
                # the same blocks, run eagerly
                tracing.count("cg.eager_solves")
                block = BLOCK_ITERS
            elif st0["x"].device.type == "cuda":
                graph = graph if graph is not None else CGGraph()
                graph.load(step, st0, BLOCK_ITERS, maxiter)
            else:
                block = 1
    if block is None:
        st, it = graph.replay()
    else:
        st = st0
        while True:
            for _ in range(block):
                st = step(st)
            tracing.count("cg.iterations_run", block)
            it, go = _read(_status(st))
            if not go:
                break
    tracing.count("cg.iterations", it)
    return st, it, b_norm_sq, zero_rhs


def _finish(st, b_norm_sq, zero_rhs, it: int, rr) -> KrylovResult:
    x = torch.where(zero_rhs, 0.0, st["x"])
    rr = torch.where(zero_rhs, 0.0, rr)
    denom = torch.sqrt(torch.where(b_norm_sq == 0.0, 1.0, b_norm_sq))
    return KrylovResult(x=x, iterations=it, residual=torch.sqrt(rr) / denom)


def _pcg_parts(matvec, precond, precond_dots, rhs, x0, tol, maxiter):
    """pcg's prologue state and its masked step."""
    def apply(r, r2=None):  # (z, <r, z>, <r, r>); r2: the product r * r, made by the step
        if precond_dots is not None:
            z, rz, rr = precond_dots(r)  # the rank's local dots
            return (z, *allsum(rz, rr)) if current_sharding() is not None else (z, rz, rr)
        rr = _dot(r, r) if r2 is None else allsum(torch.sum(r2))
        if precond is None:
            return r, rr, rr
        z = precond(r)
        return z, _dot(r, z), rr

    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = b_norm_sq == 0.0
    r = rhs - matvec(x0)
    z, rz, rr = apply(r)
    go = ~zero_rhs & (rr > tol_sq) & (maxiter > 0)
    st0 = {"x": x0, "r": r, "p": z, "rr": rr, "rz": rz, "tol_sq": torch.as_tensor(tol_sq),
           "it": torch.zeros((), dtype=torch.int32, device=rhs.device), "go": go}

    def step(st):
        go, p, rz = st["go"], st["p"], st["rz"]
        q = matvec(p)
        pq = _dot(p, q)
        # the elementwise and 0-d work in two launches on the card (ops/cgstep.py),
        # which take contiguous vectors: the caller's x0, a matvec's or a
        # preconditioner's output may be strided (the dots keep their layout)
        p = p.contiguous()
        x, r, r2 = cgstep.cg_xr(st["x"].contiguous(), st["r"].contiguous(), p, q.contiguous(),
                                pq, rz, go, rr=precond_dots is None)
        z, rz_new, rr_new = apply(r, r2)
        p, rz, rr, it, go = cgstep.cg_p(z.contiguous(), p, pq, rz, rz_new, rr_new, st["rr"],
                                        st["it"], go, st["tol_sq"], maxiter)
        return {"x": x, "r": r, "p": p, "rr": rr, "rz": rz, "tol_sq": st["tol_sq"], "it": it,
                "go": go}

    return st0, step, b_norm_sq, zero_rhs


def _pcg(matvec, rhs, x0, precond, tol, maxiter, precond_dots, graph, block) -> KrylovResult:
    st, it, b_norm_sq, zero_rhs = _run(
        lambda: _pcg_parts(matvec, precond, precond_dots, rhs, x0, tol, maxiter), graph, block,
        maxiter)
    return _finish(st, b_norm_sq, zero_rhs, it, st["rr"])


def pcg(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
        maxiter: int = 1000, precond_dots: Optional[Callable] = None,
        graph: Optional[CGGraph] = None) -> KrylovResult:
    """Preconditioned CG on an SPD operator (the JAX ``pcg``, textbook loop).

    With ``precond=None`` the identity preconditioner is specialized away: no z
    vector and no separate <r, z> reduction (rz == rr) — the solver's Jacobi
    preconditioning is the symmetric equilibration done by
    ``power.group_solve``.  Otherwise z = precond(r), rz = <r, z> and
    beta = rz_new / rz.  ``precond_dots`` (overrides ``precond``) returns
    (z, rz, rr) from r in one call.

    ``tol`` may be a float or a 0-d tensor of rhs's dtype (the adaptive inner
    tolerance).  On a CUDA tensor the iterations replay ``graph`` (a fresh
    ``CGGraph`` if None) in blocks of ``BLOCK_ITERS``; on a CPU tensor they run
    eagerly, one a block."""
    return _pcg(matvec, rhs, x0, precond, tol, maxiter, precond_dots, graph, None)


def pcg_blocks(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
               maxiter: int = 1000, precond_dots: Optional[Callable] = None,
               block: int = BLOCK_ITERS) -> KrylovResult:
    """``pcg``'s block loop run eagerly, ``block`` iterations per host read,
    on any device."""
    return _pcg(matvec, rhs, x0, precond, tol, maxiter, precond_dots, None, block)


def _fused_parts(matvec, precond, rhs, x0, tol, maxiter):
    """pcg_fused's prologue state and its masked step."""
    def dots(r, u, w):  # (gamma, delta, rr)
        gamma = _dot(r, u)
        return gamma, _dot(w, u), (gamma if precond is None else _dot(r, r))

    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = b_norm_sq == 0.0
    r = rhs - matvec(x0)
    u = r if precond is None else precond(r)
    w = matvec(u)
    gamma, delta, rr = dots(r, u, w)
    tiny = torch.finfo(rr.dtype).tiny
    breakdown = torch.abs(delta) <= tiny
    alpha = torch.where(breakdown, 0.0, gamma / torch.where(breakdown, 1.0, delta))
    st0 = {"x": x0, "r": r, "w": w, "p": torch.zeros_like(r), "s": torch.zeros_like(r),
           "gamma": gamma, "rr": rr, "alpha": alpha, "beta": torch.zeros_like(gamma),
           "tol_sq": torch.as_tensor(tol_sq),
           "it": torch.zeros((), dtype=torch.int32, device=rhs.device),
           "go": ~zero_rhs & (rr > tol_sq) & ~breakdown & (maxiter > 0)}
    if precond is not None:  # with M = I, u is r
        st0["u"] = u

    def step(st):
        go, alpha = st["go"], st["alpha"]
        a = torch.where(go, alpha, 0.0)
        b = torch.where(go, st["beta"], 0.0)
        p = st.get("u", st["r"]) + b * st["p"]
        s = st["w"] + b * st["s"]
        x = st["x"] + a * p
        r = st["r"] - a * s
        u = r if precond is None else precond(r)
        w = matvec(u)
        gamma_new, delta, rr_new = dots(r, u, w)
        beta = gamma_new / torch.where(st["gamma"] == 0.0, 1.0, st["gamma"])
        denom = delta - beta * gamma_new / torch.where(go, alpha, 1.0)
        breakdown = torch.abs(denom) <= tiny
        alpha_new = torch.where(breakdown, 0.0, gamma_new / torch.where(breakdown, 1.0, denom))
        it = st["it"] + go
        rr = torch.where(go, rr_new, st["rr"])
        out = {"x": x, "r": r, "w": w, "p": p, "s": s,
               "gamma": torch.where(go, gamma_new, st["gamma"]), "rr": rr,
               "alpha": torch.where(go, alpha_new, alpha),
               "beta": torch.where(go, beta, st["beta"]), "tol_sq": st["tol_sq"], "it": it,
               "go": go & ~breakdown & (rr > st["tol_sq"]) & (it < maxiter)}
        if precond is not None:
            out["u"] = u
        return out

    return st0, step, b_norm_sq, zero_rhs


def _pcg_fused(matvec, rhs, x0, precond, tol, maxiter, graph, block) -> KrylovResult:
    st, it, b_norm_sq, zero_rhs = _run(
        lambda: _fused_parts(matvec, precond, rhs, x0, tol, maxiter), graph, block, maxiter)
    return _finish(st, b_norm_sq, zero_rhs, it, torch.abs(st["rr"]))


def pcg_fused(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
              maxiter: int = 1000, graph: Optional[CGGraph] = None) -> KrylovResult:
    """Chronopoulos-Gear PCG (the JAX ``pcg_fused``): with u = M r, w = A u,

        p <- u + beta p;  s <- w + beta s;  x <- x + alpha p;  r <- r - alpha s
        gamma' = <r, u>;  delta = <w, u>  [rr = <r, r> when M != I]
        beta = gamma' / gamma;  alpha = gamma' / (delta - beta gamma' / alpha)

    Same fixed point and stopping rule as ``pcg``; the residual is
    sqrt(|rr|) / ||b||.  ``graph`` as in ``pcg``."""
    return _pcg_fused(matvec, rhs, x0, precond, tol, maxiter, graph, None)


def pcg_fused_blocks(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
                     maxiter: int = 1000, block: int = BLOCK_ITERS) -> KrylovResult:
    """``pcg_fused``'s block loop run eagerly, ``block`` iterations per host
    read, on any device."""
    return _pcg_fused(matvec, rhs, x0, precond, tol, maxiter, None, block)


def _bicgstab_parts(matvec, precond, rhs, x0, tol, maxiter):
    """bicgstab's prologue state and its masked step: the JAX body
    (``neutfem_tpu/krylov.py:272-292``) in its order — rho, beta, p, phat, v,
    alpha, s, shat, t, the (t, t) and (t, s) dots, omega, x, r — with beta,
    alpha and omega masked to 0 once the stop test has failed."""
    b_norm_sq = _dot(rhs, rhs)
    tol_sq = tol * tol * b_norm_sq
    zero_rhs = b_norm_sq == 0.0
    r = rhs - matvec(x0)
    rr = _dot(r, r)
    tiny = torch.finfo(rr.dtype).tiny
    one = torch.ones((), dtype=rr.dtype, device=rr.device)
    st0 = {"x": x0, "r": r, "rhat": r, "p": r, "v": torch.zeros_like(r), "rho": one,
           "alpha": one, "omega": one, "rr": rr, "tol_sq": torch.as_tensor(tol_sq),
           "it": torch.zeros((), dtype=torch.int32, device=rhs.device),
           "go": ~zero_rhs & (rr > tol_sq) & (maxiter > 0)}

    def step(st):
        go, r, rhat, omega = st["go"], st["r"], st["rhat"], st["omega"]
        rho_new = _dot(rhat, r)
        safe_rho = torch.where(st["rho"] == 0, 1.0, st["rho"])
        safe_omega = torch.where(omega == 0, 1.0, omega)
        beta = torch.where(go, (rho_new / safe_rho) * (st["alpha"] / safe_omega), 0.0)
        p = r + beta * (st["p"] - omega * st["v"])
        phat = p if precond is None else precond(p)
        v = matvec(phat)
        rv = _dot(rhat, v)
        alpha = torch.where(go, rho_new / torch.where(rv == 0, 1.0, rv), 0.0)
        s = r - alpha * v
        shat = s if precond is None else precond(s)
        t = matvec(shat)
        tt, ts = _dot(t, t), _dot(t, s)
        omega_new = torch.where(go, ts / torch.where(tt == 0, 1.0, tt), 0.0)
        x = (st["x"] + omega_new * shat) + alpha * phat
        r = s - omega_new * t
        breakdown = (torch.abs(rho_new) <= tiny) | (tt == 0)
        it = st["it"] + go
        rr = torch.where(go, _dot(r, r), st["rr"])
        return {"x": x, "r": r, "rhat": rhat, "p": p, "v": v,
                "rho": torch.where(go, rho_new, st["rho"]), "alpha": alpha, "omega": omega_new,
                "rr": rr, "tol_sq": st["tol_sq"], "it": it,
                "go": go & ~breakdown & (rr > st["tol_sq"]) & (it < maxiter)}

    return st0, step, b_norm_sq, zero_rhs


def _bicgstab(matvec, rhs, x0, precond, tol, maxiter, graph, block) -> KrylovResult:
    st, it, b_norm_sq, zero_rhs = _run(
        lambda: _bicgstab_parts(matvec, precond, rhs, x0, tol, maxiter), graph, block, maxiter)
    return _finish(st, b_norm_sq, zero_rhs, it, st["rr"])


def bicgstab(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
             maxiter: int = 1000, graph: Optional[CGGraph] = None) -> KrylovResult:
    """Right-preconditioned BiCGSTAB (the JAX ``bicgstab``; works for
    non-symmetric operators): rhat = r0, rho = alpha = omega = 1, p = r0,
    v = 0, then per iteration

        rho' = <rhat, r>;  beta = (rho' / rho) (alpha / omega)
        p <- r + beta (p - omega v);  v = A M p;  alpha = rho' / <rhat, v>
        s = r - alpha v;  t = A M s;  omega = <t, s> / <t, t>
        x <- x + omega M s + alpha M p;  r = s - omega t

    with the JAX package's guards (a zero rho or omega reads as 1, a zero
    <rhat, v> or <t, t> as 1) and its stop test: ||r||^2 < tol^2 ||b||^2, a
    breakdown |rho'| <= tiny or <t, t> = 0, maxiter, or a zero rhs (x = 0).
    ``graph`` as in ``pcg``: on a CUDA tensor the iterations replay it in
    blocks of ``BLOCK_ITERS``."""
    return _bicgstab(matvec, rhs, x0, precond, tol, maxiter, graph, None)


def bicgstab_blocks(matvec: Callable, rhs, x0, precond: Optional[Callable] = None, tol=1e-10,
                    maxiter: int = 1000, block: int = BLOCK_ITERS) -> KrylovResult:
    """``bicgstab``'s block loop run eagerly, ``block`` iterations per host
    read, on any device."""
    return _bicgstab(matvec, rhs, x0, precond, tol, maxiter, None, block)
