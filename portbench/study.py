"""The readings the limits of the check are set from, on the card, at each
cell's own size: for each seed, the program's answer of one cold solve on
the timed path (after the warm-up solve, as in a run's window) and the
controls in its place, judged by ``reference/``.

    python3 -m portbench.study --workload <cell> --seeds <n> [<n> ...] [--out FILE]

Per seed, one JSON line: the outer and inner counts, the solve's wall, and
the readings (``k_gap``, ``fick_res``, ``balance_res``) of

* ``program``: the answer as the program returned it;
* ``bf16``: the control, the reference in the program's place in bfloat16:
  the program's flux held in bfloat16, the current worked out from it by the
  reference's Fick solve and k its Rayleigh quotient
  (``reference.check.bfloat16_control``);
* ``tf32`` (the first ``--tf32-seeds`` seeds): a fresh facade built, warmed
  up (its CG graphs captured) and solved with TF32 allowed for the
  program's float32 matrix products (the configuration states float32 with
  TF32 off), and whether its answer equals the program's bit for bit;
* ``unchanged``: the flat start flux and k = 1 with a zero current, what a
  solve that returns its state unchanged hands back.

Not a benchmark run: no window, no result line.  Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from . import manifest, system
from .inputs import build_inputs
from .reference.check import Operators, bfloat16_control, judge
from .run import _set_environment


def _readings(r):
    return {k: r[k] for k in ("k_gap", "fick_res", "balance_res", "k_rq")}


def _tf32_solve(config, inputs):
    """A fresh facade with TF32 allowed from its build on: its answer and counts."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        solver, _ = system.make_solver(config, inputs, "cuda")
        system.solve(solver)  # warm-up: the graphs are captured with TF32 allowed
        system.solve(solver)
        return system.to_host(system.state(solver)), system.counts(solver)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _same(a, b) -> bool:
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and all(
        np.array_equal(a[2][key][p], b[2][key][p]) for key in a[2] for p in a[2][key])


def study_seed(cell, seed: int, tf32: bool = True) -> dict:
    import torch

    config = cell.config
    inputs = build_inputs(config, seed, cell.traffic)
    t0 = time.perf_counter()
    solver, build = system.make_solver(config, inputs, "cuda")
    system.solve(solver)  # warm-up, as in a run's set-up
    t1 = time.perf_counter()
    k = system.solve(solver)
    wall = time.perf_counter() - t1
    outers, inners = system.counts(solver)
    prog = system.to_host(system.state(solver))
    del solver
    gc.collect()
    torch.cuda.empty_cache()
    tf32_out = _tf32_solve(config, inputs) if tf32 else None
    gc.collect()
    torch.cuda.empty_cache()
    ops = Operators(inputs, config["discretization"]["rt_order"])
    kk, phi, J = prog
    flat = (1.0, np.ones_like(phi), {key: {p: np.zeros_like(a) for p, a in e.items()}
                                    for key, e in J.items()})
    t2 = time.perf_counter()
    out = {"seed": seed, "k": k, "outers": outers, "inners": inners, "solve_s": wall,
           "setup_s": t1 - t0, "build_s": build,
           "program": _readings(judge(ops, *prog))}
    out["judge_s"] = time.perf_counter() - t2
    control = bfloat16_control(ops, phi)
    out["bf16"] = {**_readings(judge(ops, *control)), "k": control[0]}
    if tf32_out is not None:
        ans, (o, i) = tf32_out
        out["tf32"] = {**_readings(judge(ops, *ans)), "outers": o, "inners": i, "k": ans[0],
                       "bit_equal": _same(ans, prog)}
    out["unchanged"] = _readings(judge(ops, *flat))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--tf32-seeds", type=int, default=3,
                   help="how many of the first seeds also get the TF32 facade")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cell = manifest.load_cell(a.workload)
    _set_environment(cell.config)
    import torch

    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 2
    sink = open(a.out, "a") if a.out else None
    try:
        for n, seed in enumerate(a.seeds):
            line = json.dumps({"workload": a.workload,
                               **study_seed(cell, seed, tf32=n < a.tf32_seeds)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
