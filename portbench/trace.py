"""The traced solves: ``torch.profiler`` around a stated number of whole
solves, and the reduction of its timeline to what the per-layer metrics and
the breakdown read.

The reduction works on plain (start, end, name) tuples in microseconds, so
its arithmetic is tested without a card.  Device busy time is the union of
the device intervals inside the traced window (the benchmark's own spans
around the solves), not the sum of kernel times, so overlapping work counts
once.  Each idle gap of the device is labelled by what the host was doing at
its middle: the innermost host event (an operator, a runtime call or one of
the benchmark's spans) that spans it.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["FAMILIES", "family", "SPAN", "reduce_timeline", "profile", "timeline"]

Interval = Tuple[float, float, str]

#: The benchmark's span around each traced solve; the facade calls inside it
#: carry ``portbench.<call>``.
SPAN = "portbench.solve"

#: Kernel-name fragment -> family, first match wins: a copy of
#: ``neutfem_tpu_torch/trace_solve.py``'s table at 814381f.
FAMILIES = (
    ("fused_dir_batched_kernel", "thread-per-line batched directions (replaced K1 batch, K5)"),
    ("fused_dir_kernel", "thread-per-line fused Schur directions (replaced K1-K3)"),
    ("fused_z_rows_batched_kernel", "tiled batched fused Schur direction z (K1 batch)"),
    ("fused_z_rows_kernel", "tiled fused Schur direction z (K1)"),
    ("fused_rows_batched_kernel", "tiled batched fused Schur directions y, x (K5)"),
    ("fused_rows_kernel", "tiled fused Schur directions y, x (K2, K3)"),
    ("fused_ho_rows_kernel", "tiled condensed Schur directions (K6)"),
    ("fused_ho_kernel", "condensed Schur directions, thread per (mode, line) (old K6)"),
    ("thomas_wide_rows_kernel", "tiled Thomas solve, few long lines (K4')"),
    ("thomas_wide_kernel", "Thomas solve, few long lines, thread per chunk (replaced K4')"),
    ("thomas_rows_kernel", "tiled Thomas solve (K4)"),
    ("thomas_kernel", "Thomas solve, thread per line (replaced K4)"),
    ("fused_eq_rows_kernel", "tiled equilibration-folded Schur directions (K7)"),
    ("fused_eq_kernel", "thread-per-line equilibration-folded directions (replaced K7)"),
    ("blockjac_dev_kernel", "tiled block-Jacobi apply + dots, fp8 E-form (K8, default)"),
    ("blockjac_tiled_kernel", "tiled block-Jacobi apply + dots, inverse (K8, BLOCKJAC=1)"),
    ("blockjac", "block-Jacobi apply + dots, thread per cell (replaced K8)"),
    ("gemv", "gemv (block-Jacobi apply; two-grid coarse apply)"),
    ("nvjet", "gemv (block-Jacobi apply; two-grid coarse apply)"),
    ("reduce_kernel", "reductions (dot products, norms)"),
    ("elementwise", "elementwise (axpy, scaling, C*v)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "other"


def _union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """Merged intervals clipped to [lo, hi], in order."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps: Sequence[Tuple[float, float]], host: Sequence[Interval]) -> List[str]:
    """For each gap (in order), the name of the shortest host interval that
    spans its middle, or "no host event"."""
    events = sorted(host)
    labels = []
    heap: List[Tuple[float, float, str]] = []  # (duration, end, name) of started events
    i = 0
    for s, e in gaps:
        m = 0.5 * (s + e)
        while i < len(events) and events[i][0] <= m:
            hs, he, name = events[i]
            heapq.heappush(heap, (he - hs, he, name))
            i += 1
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        labels.append(heap[0][2] if heap else "no host event")
    return labels


def reduce_timeline(device: Sequence[Interval], host: Sequence[Interval],
                    window: Tuple[float, float], top: int = 10) -> Dict:
    """Busy and idle time of the device inside ``window`` (microseconds in,
    seconds out): ``busy_s``, ``window_s``, ``launches`` (device operations
    that start inside the window), ``device_ops`` (seconds by kernel family,
    the ``top`` largest) and ``idle_gaps`` (idle seconds by what the host was
    doing, the ``top`` largest)."""
    lo, hi = window
    inside = [(s, e, n) for s, e, n in device if lo <= s < hi]
    merged = _union(((s, e) for s, e, _ in device), lo, hi)
    busy = sum(e - s for s, e in merged)
    fam: Dict[str, float] = {}
    for s, e, n in inside:
        f = family(n)
        fam[f] = fam.get(f, 0.0) + (min(e, hi) - s)
    gaps = []
    cursor = lo
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    idle: Dict[str, float] = {}
    for (s, e), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] = idle.get(label, 0.0) + (e - s)

    def top_of(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6, "launches": len(inside),
            "device_ops": top_of(fam), "idle_gaps": top_of(idle)}


def profile(fn, n: int):
    """Run ``fn()`` n times under ``torch.profiler`` (host and device), each
    call inside the span ``SPAN``.  Returns (profiler, results)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    results = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            with torch.profiler.record_function(SPAN):
                results.append(fn())
        torch.cuda.synchronize()
    return prof, results


def timeline(prof):
    """(device intervals, host intervals, window) of a finished profile, in
    microseconds; the window runs from the first ``SPAN``'s start to the last
    one's end."""
    import torch

    device, host, spans = [], [], []
    for e in prof.events():
        iv = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors each host span onto the device's timeline
            # ("gpu_user_annotation"); those are not device work
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")):
                device.append(iv)
        elif e.name == SPAN:
            spans.append(iv)
        else:
            host.append(iv)
    if not spans:
        raise RuntimeError("the trace holds no solve span")
    return device, host, (min(s for s, _, _ in spans), max(e for _, e, _ in spans))
