"""One run of one benchmark cell of ``neutfem_tpu_torch``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks for:

1. set up: imports, CUDA, the kernel library (built at the checkout's first
   run into ``neutfem_tpu_torch/_build/``, loaded after), and for each of the
   traffic mix's cross-section samples its inputs (``inputs.py``), a facade,
   ``BuildMatrices`` and one warm-up solve, which captures the CG graphs;
2. the window: back-to-back cold solves (``reset_flux`` + ``SolveKeff``), one
   client, the samples in turns in an order drawn from ``--seed``, until
   ``--seconds`` have passed; it ends at the last completed solve;
3. with ``--trace 1``, ``traffic["profiled_solves"]`` more whole solves under
   ``torch.profiler`` at the end of the window;
4. the check that decides ``correct`` (``reference/``), after the window
   has closed, the peak memory has been read and the program freed: each
   sample's last answer and one solve's drawn from ``--seed`` (k, flux,
   current), and every solve's k against its sample's reference;
5. the result: the last line of standard output, one JSON object.

A run that finds no card, or fewer cards than the cell asks for, or that has
loaded JAX or the JAX package once the window has closed, exits with code 2
and prints no result.  ``run_cell`` is the whole run on a given device; the
CPU rehearsal of the tests calls it with ``device="cpu"``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before any heavy import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import manifest, roofline, stats, system, trace  # noqa: E402
from .guard import forbidden_modules  # noqa: E402
from .inputs import build_inputs  # noqa: E402
from .reference.check import Operators, bfloat16_control, judge  # noqa: E402

__all__ = ["run_cell", "main"]

#: Environment the program reads that the configuration's ``facade.env`` sets
#: alone: anything else of that name is removed before the program loads.
_PROGRAM_ENV_PREFIX = "NEUTFEM_"


def _set_environment(config: Dict) -> None:
    for key in [k for k in os.environ if k.startswith(_PROGRAM_ENV_PREFIX)]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in config["facade"]["env"].items()})


def _gap(k: float, k_rq: float) -> float:
    """|k - k_rq| / k_rq; infinite where that is no finite number."""
    if not (np.isfinite(k_rq) and k_rq > 0 and np.isfinite(k)):
        return float("inf")
    return abs(k - k_rq) / k_rq


def _nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
                              "power.limit,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _host_state(cuda: bool) -> Dict:
    """What may differ from one process to the next around the window: the
    host CPU time of this process, the card's clocks and power, the
    allocator's reserved bytes."""
    import torch

    out = {"cpu_s": time.process_time()}
    if cuda:
        out["reserved_bytes"] = int(torch.cuda.memory_reserved())
        out["nvidia_smi"] = _nvidia_smi()
    return out


def _print_window_diagnostics(before: Dict, after: Dict, solves, log) -> None:
    """One line on standard error: the first solves' walls beside the median,
    the host CPU seconds a solve, and the host's and card's state at both
    ends of the window (to tell host, card and allocator apart when runs
    differ)."""
    walls = [s["wall_s"] for s in solves]
    n = max(len(walls), 1)
    diag = {"first_walls_s": walls[:3], "median_wall_s": float(np.median(walls)) if walls else None,
            "host_cpu_s_per_solve": (after["cpu_s"] - before["cpu_s"]) / n,
            "before": {k: v for k, v in before.items() if k != "cpu_s"},
            "after": {k: v for k, v in after.items() if k != "cpu_s"}}
    print(f"window diagnostics: {json.dumps(diag)}", file=log)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             control: Optional[str] = None, log=sys.stderr, warmup: bool = True) -> Dict:
    """The whole run of ``cell``; returns the result object.  ``control="bf16"``
    judges the bfloat16 control in the program's place (each answer's flux
    held in bfloat16, its current and k worked out from that flux by the
    reference, ``reference.check.bfloat16_control``) instead of the program's
    own answers.  ``warmup=False`` (the CPU rehearsal, which has no graphs
    to capture) skips the warm-up solve."""
    import torch

    config, traffic = cell.config, cell.traffic
    cuda = device == "cuda"

    # -- set-up: one facade for each cross-section sample of the mix ----------
    sample_seeds = [int(v) for v in traffic["xs_sample"]["samples"]]
    inputs = [build_inputs(config, sid, traffic) for sid in sample_seeds]
    solvers, build_span = [], 0.0
    for inp in inputs:
        solver, span = system.make_solver(config, inp, device)
        solvers.append(solver)
        build_span += span
        if warmup:
            system.solve(solver)  # the warm-up solve: captures the CG graphs
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    build_seconds = {}
    for solver in solvers:
        for key, v in system.build_seconds(solver).items():
            build_seconds[key] = build_seconds.get(key, 0.0) + v
    print(f"set-up {setup_s:.3f} s (BuildMatrices {build_span:.3f} s over {len(solvers)} "
          f"samples, the program's own {build_seconds})", file=log)

    # -- the window: the samples in the seed's order, round and round ----------
    rng = np.random.default_rng([int(seed), 1])
    order = [int(j) for j in rng.permutation(len(solvers))]
    solves = []
    failed = 0
    kept = None  # (solve index, sample, state): a reservoir sample of one solve
    before = _host_state(cuda)
    t0 = time.perf_counter()
    end = t0
    while True:
        j = order[len(solves) % len(order)]
        a = time.perf_counter()
        try:
            k = system.solve(solvers[j])
        except Exception:  # a solve that raises is a failed request; the window goes on
            traceback.print_exc(file=log)
            failed += 1
            k = None
        end = time.perf_counter()
        outers, inners = system.counts(solvers[j])
        solves.append({"wall_s": end - a, "k": k, "outers": outers, "inners": inners,
                       "sample": j})
        if k is not None and rng.random() * len(solves) < 1.0:
            kept = (len(solves) - 1, j, system.clone_state(solvers[j]))
        if end - t0 >= seconds and len(solves) >= len(solvers):  # at least one round
            break
    window = {"start": t0, "end": end}
    _print_window_diagnostics(before, _host_state(cuda), solves, log)

    # -- the traced solves, continuing the order -------------------------------
    traced_rec = None
    breakdown = None
    if traced:
        cursor = [len(solves)]

        def one():
            j = order[cursor[0] % len(order)]
            cursor[0] += 1
            with torch.profiler.record_function("portbench.reset_flux"):
                solvers[j].reset_flux()
            with torch.profiler.record_function("portbench.SolveKeff"):
                solvers[j].SolveKeff()
            return system.counts(solvers[j])

        prof, counts = trace.profile(one, int(traffic["profiled_solves"]))
        tl = trace.reduce_timeline(*trace.timeline(prof))
        del prof
        traced_rec = {"solves": [{"outers": o, "inners": i} for o, i in counts], **tl}
        breakdown = {"device_ops": tl["device_ops"], "idle_gaps": tl["idle_gaps"]}

    # -- what the run used, then the check -----------------------------------
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if traced_rec is not None:
        dev["busy_s"] = traced_rec["busy_s"]
        dev["window_s"] = traced_rec["window_s"]
    smi = _nvidia_smi() if cuda else None
    print(f"device {dev['kind']}: peak memory {dev['memory_peak_bytes']} bytes; "
          f"nvidia-smi (name, sm MHz, mem MHz, power draw, power limit, C): {smi}", file=log)

    record = {"config": config, "traffic": traffic, "shape": list(inputs[0].shape),
              "setup_s": setup_s, "build_span_s": build_span, "build_seconds": build_seconds,
              "solves": solves, "window": window, "trace": traced_rec,
              "roofline": roofline.bound_seconds(config, inputs[0].shape, dev["kind"])}

    # the judged answers: each sample's last solve and the kept one, as
    # (sample, answer on the host)
    answers = {f"sample {sample_seeds[j]} last": (j, system.to_host(system.state(solver)))
               for j, solver in enumerate(solvers)}
    if kept is not None and control is None:
        answers[f"sample {sample_seeds[kept[1]]} solve {kept[0]}"] = (kept[1],
                                                                       system.to_host(kept[2]))
    del solvers, solver, kept
    if cuda:
        torch.cuda.empty_cache()
    order_k = config["discretization"]["rt_order"]
    ops = [Operators(inp, order_k) for inp in inputs]
    if control == "bf16":
        answers = {name: (j, bfloat16_control(ops[j], a[1])) for name, (j, a) in answers.items()}
    readings = {name: judge(ops[j], *a) for name, (j, a) in answers.items()}
    k_rq = [readings[f"sample {sid} last"]["k_rq"] for sid in sample_seeds]
    values = {key: max(r[key] for r in readings.values())
              for key in ("k_gap", "fick_res", "balance_res")}
    if control is None:  # every solve's k against its sample's reference
        values["k_gap"] = max([values["k_gap"]] + [_gap(s["k"], k_rq[s["sample"]])
                                                   for s in solves if s["k"] is not None])
    lim = {name: c["limit"] for name, c in cell.limits.items()
           if isinstance(c, dict) and c.get("limit") is not None}
    cap = config["tol"]["max_outer"]
    for s in solves:
        if s["k"] is not None and (s["outers"] >= cap or (
                control is None and not _gap(s["k"], k_rq[s["sample"]]) <= lim["k_gap"])):
            failed += 1
    checks = {name: {"value": values[name], "limit": limit} for name, limit in lim.items()}
    within = all(c["value"] <= c["limit"] for c in checks.values())
    correct = bool(within and failed == 0 and solves)
    record["checks"] = checks

    # -- the metrics ----------------------------------------------------------
    metrics = {}
    done = [s for s in solves if s["k"] is not None]
    if not traced:
        walls = [s["wall_s"] for s in solves]
        values = {"setup_s": setup_s,
                  "solve_s": stats.window_mean(t0, end, len(done)) if done else None,
                  "solve_p90_s": stats.nearest_rank(walls, 90)}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    counts_line = {"samples": sample_seeds, "order": order, "solves": len(solves),
                   "outers": sorted({(s["sample"], s["outers"]) for s in solves}),
                   "inners": sorted({(s["sample"], s["inners"]) for s in solves}),
                   "k": sorted({(s["sample"], s["k"]) for s in done}), "readings": readings}
    print(f"window: {json.dumps(counts_line)}", file=log)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one portbench cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    cell = manifest.load_cell(a.workload)
    _set_environment(cell.config)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"portbench: the run loaded JAX or the JAX package: {loaded}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
