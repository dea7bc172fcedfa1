"""The program's own records of a run (``neutfem_tpu_torch.tracing``), for the
per-layer metrics that read them: one record a solve (its spans, counters
and outer count) and one a context build.

Besides ``system.py``, the only module of the benchmark that imports the
port, inside its functions: the records live in the process that ran the
solves, and the metrics are read in it, after the window and the traced
solves.  A program without these records (older than them) has nothing to
read: every function then returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["window_solves", "sample_builds", "span_seconds", "span_count", "counter"]


def _tracing():
    try:
        from neutfem_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def window_solves(record: Dict) -> Optional[List[Dict]]:
    """The program's records of the window's solves.  The run's last solves
    are the window's W and then the T traced ones, so these are the newest
    W + T records less the last T: the untraced window, whose host times
    carry no profiler cost.  None without a trace, with fewer records, or
    unless each record's outer count is its window solve's, in order."""
    tracing, tr = _tracing(), record.get("trace")
    if tracing is None or not tr:
        return None
    w, t = len(record["solves"]), len(tr["solves"])
    recs = tracing.recent(w + t)
    if w == 0 or len(recs) != w + t:
        return None
    window = recs[:w]
    if [r["outers"] for r in window] != [s["outers"] for s in record["solves"]]:
        return None
    return window


def sample_builds(record: Dict) -> Optional[List[Dict]]:
    """The build records of the set-up: the newest one for each of the mix's
    cross-section samples (one facade, one build each).  None where the
    program kept fewer."""
    tracing = _tracing()
    if tracing is None:
        return None
    n = len(record["traffic"]["xs_sample"]["samples"])
    builds = tracing.recent_builds(n)
    return builds if n and len(builds) == n else None


def span_seconds(recs: List[Dict], prefix: str) -> float:
    """Seconds of the spans whose names start with ``prefix``, over ``recs``."""
    return sum(sec for r in recs for name, (_, sec) in r["spans"].items()
               if name.startswith(prefix))


def span_count(recs: List[Dict], prefix: str) -> int:
    """Count of the spans whose names start with ``prefix``, over ``recs``."""
    return sum(n for r in recs for name, (n, _) in r["spans"].items() if name.startswith(prefix))


def counter(recs: List[Dict], name: str) -> int:
    return sum(r["counters"].get(name, 0) for r in recs)
