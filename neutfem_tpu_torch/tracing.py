"""Spans, counters and per-solve records of the port.

* ``span(name)``: a context manager that adds its host duration
  (``time.perf_counter_ns``) and a count to the process totals of
  ``name``.  While a ``torch.profiler`` session is active it also opens
  ``torch.profiler.record_function(name)``, so the span is on the profiler's
  own clock and a trace labels host time and device gaps by it; with no
  profiler it makes none.  No span is opened inside a captured CUDA graph's
  step: spans go around ``graph.replay()``, never in what is captured.
* ``sync(site)``: the span ``neutfem.sync.<site>`` around a host call on the
  solve path that waits for the device (a read of a device value, or a
  pageable host-to-device copy of a Python number, which ATen finishes with a
  stream synchronisation).  A site counts on every device, so the CPU tests
  hold the same counts as the card.
* ``count(name, n)``: add to a counter's process total (``total``; ``totals``
  copies them all).  Every counter of the port is one, ``<prefix>.<key>``; a
  reader takes a difference of totals or zeroes its names (``reset_totals``).
  What a captured CUDA graph's step counts is taken back after the capture
  and counted again at each replay (``krylov.CGGraph``).
* Records: ``span(SOLVE, record="solve")`` (the facade's ``SolveKeff`` and
  ``SolveAdjoint``) and ``span(BUILD, record="build")`` (the facade's
  context build) open one.  Closed, it is appended to a bounded deque
  (``MAX_RECORDS``) as ``{"kind", "spans": {name: (count, seconds)},
  "counters": {name: n}, "outers"}``; ``recent(n)`` / ``recent_builds(n)``
  return the newest, oldest first.  A record is what the totals gained
  while it was open, so nested records each hold everything inside them.
  ``collect()`` opens a record that is kept by the caller alone.

The names the program emits (who reads each: PERF.md section 3):

    neutfem.solve, neutfem.outer, neutfem.group_solve, neutfem.cg.prologue,
    neutfem.cg.replay, neutfem.cg.capture, neutfem.current;
    neutfem.sync.{cg_read, stop_test, upload, result, capture};
    neutfem.build, neutfem.context.{directions, schur_diag, line, blockjac,
    to_device}, neutfem.twogrid.attach;
    cg.{solves, iterations, iterations_run, host_reads, replays, captures,
    eager_solves}, context.blockjac_blocks, precond.line_applies;
    the kernel launches (counted by the wrapper where it launches; none on
    a CPU tensor): fused.{z, y, x}_rows, fused.{z, y, x}_batched_rows,
    thomas.{thomas_rows, thomas_wide_rows}, fused_ho.ho_{z, y, x}_rows,
    fused_eq.{x_eq, z_eq, x_eq2, y_eq2, z_eq2}_rows,
    blockjac.{blockjac_tiled, blockjac_dev}, cgstep.{cg_xr, cg_p};
    parttri.{parttri, scan} (the cut direction's face solves);
    comm.{collectives, comm_bytes, staged_bytes}
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["span", "sync", "count", "total", "totals", "reset_totals", "set_outers", "collect", "recent",
           "recent_builds", "SOLVE", "BUILD", "SYNC", "MAX_RECORDS"]

SOLVE = "neutfem.solve"
BUILD = "neutfem.build"
#: The prefix of every synchronisation site's span.
SYNC = "neutfem.sync."
#: Closed records kept of each kind.
MAX_RECORDS = 4096

_TOTALS: Dict[str, int] = collections.defaultdict(int)  # counter -> process total
_SPANS: Dict[str, list] = {}  # span -> [count, nanoseconds], process totals
_OPEN: List[dict] = []  # the open records, innermost last
_SOLVES: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_BUILDS: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_profiling = torch._C._autograd._profiler_enabled
_ns = time.perf_counter_ns


def _open(kind: str) -> dict:
    """A record opened now: the process totals it will be the difference from."""
    rec = {"kind": kind, "outers": None, "spans0": {k: tuple(v) for k, v in _SPANS.items()},
           "counters0": dict(_TOTALS)}
    _OPEN.append(rec)
    return rec


def _close(rec: dict) -> dict:
    """Take the open record ``rec`` off the stack (by identity) and return
    it closed: what the totals gained while it was open, span times in
    seconds."""
    del _OPEN[next(i for i in range(len(_OPEN) - 1, -1, -1) if _OPEN[i] is rec)]
    spans = {}
    for k, (n, ns) in _SPANS.items():
        n0, ns0 = rec["spans0"].get(k, (0, 0))
        if n > n0:
            spans[k] = (n - n0, (ns - ns0) / 1e9)
    c0 = rec["counters0"]
    return {"kind": rec["kind"], "spans": spans, "outers": rec["outers"],
            "counters": {k: v - c0.get(k, 0) for k, v in _TOTALS.items() if v != c0.get(k, 0)}}


class span:
    """Time a block under ``name`` (the process totals, so every open
    record); ``record`` ("solve" or "build") opens a record around it,
    closed and kept when the block ends (also by an exception)."""

    __slots__ = ("name", "record", "rec", "t0", "rf")

    def __init__(self, name: str, record: Optional[str] = None):
        self.name = name
        self.record = record

    def __enter__(self):
        self.rec = None if self.record is None else _open(self.record)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = _ns()
        return self

    def __exit__(self, *exc):
        dt = _ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s = _SPANS.get(self.name)
        if s is None:
            _SPANS[self.name] = [1, dt]
        else:
            s[0] += 1
            s[1] += dt
        if self.rec is not None:
            (_SOLVES if self.record == "solve" else _BUILDS).append(_close(self.rec))
        return False


def sync(site: str) -> span:
    """The span of a synchronisation site: ``neutfem.sync.<site>``."""
    return span(SYNC + site)


def count(name: str, n: int = 1) -> None:
    _TOTALS[name] += n


def total(name: str) -> int:
    """The process total of counter ``name`` since its last reset."""
    return _TOTALS.get(name, 0)


def totals() -> Dict[str, int]:
    """A copy of every counter's process total."""
    return dict(_TOTALS)


def reset_totals(names: Iterable[str]) -> None:
    """Zero the counters ``names``; a record open across the reset still
    reads all they gained while it was open."""
    for name in names:
        for rec in _OPEN:
            rec["counters0"][name] = rec["counters0"].get(name, 0) - _TOTALS[name]
        _TOTALS[name] = 0


def set_outers(n: int) -> None:
    """The outer count of the innermost open solve record."""
    for rec in reversed(_OPEN):
        if rec["kind"] == "solve":
            rec["outers"] = int(n)
            return


class collect:
    """A record of what happens inside the block, kept by the caller only:
    ``with collect() as c: ...``, then ``c.record``."""

    def __enter__(self):
        self.rec = _open("collect")
        self.record = None
        return self

    def __exit__(self, *exc):
        self.record = _close(self.rec)
        return False


def _newest(d: collections.deque, n: int) -> List[dict]:
    return list(d)[-n:] if n > 0 else []


def recent(n: int) -> List[dict]:
    """The newest ``n`` solve records (fewer if fewer are kept), oldest first."""
    return _newest(_SOLVES, n)


def recent_builds(n: int) -> List[dict]:
    """The newest ``n`` build records, oldest first."""
    return _newest(_BUILDS, n)
