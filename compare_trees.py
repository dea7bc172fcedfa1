"""Benchmark rows of several checkouts of this repository, in turns, on one card.

    python compare_trees.py --tree P=DIR --tree C=. --order PCCP \\
        [--rows main,ho2,zion2d,scale,adjoint]
    python compare_trees.py --tree A=.:4 --tree B=.:8 --order ABBA --rows main,ho2

Each letter of ``--order`` is one pass: a process started in that tree (its
own ``neutfem_tpu_torch``, kernels built in its own ``_build``) that runs
every row of ``--rows`` through the tree's ``bench`` entry points and prints
one JSON line per row: the row's ms/outer, counts and k, the peak device
memory of the row (``torch.cuda.max_memory_allocated``, reset before it) and,
where the tree's ``bench`` reports it, the CG's host reads.  A tree given as
``DIR:K`` sets ``neutfem_tpu_torch.krylov.BLOCK_ITERS`` to K in its passes
(the CG's iterations per host read).  Passes run one after another, never
two at once.  The last line is a JSON summary: per tree and row the ms/outer
of each pass.  Needs a CUDA device.

Rows: main (``bench.main(6, 4)``), ho1 / ho2 (``main_ho``), ho2_bf16 /
ho2_cgcg (``main_ho(2)`` under ``NEUTFEM_BLKFP8=0`` / ``NEUTFEM_CGCG=1``),
koeberg2d / zion2d (``main_2d``), scale (``main_scale``), adjoint
(``main_adjoint``), jacobi (``main_sweep("jacobi")``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = {
    "main": "bench.main(6, 4)",
    "ho1": "bench.main_ho(1)",
    "ho2": "bench.main_ho(2)",
    "ho2_bf16": "switched(bench.main_ho, 2, NEUTFEM_BLKFP8='0')",
    "ho2_cgcg": "switched(bench.main_ho, 2, NEUTFEM_CGCG='1')",
    "koeberg2d": "bench.main_2d('koeberg2d', 32)",
    "zion2d": "bench.main_2d('zion2d', 48)",
    "scale": "bench.main_scale()",
    "adjoint": "bench.main_adjoint()",
    "jacobi": "bench.main_sweep('jacobi')",
}

# one pass: the rows in order, each after freeing the last row's memory
_PASS = """
import gc, json, sys, torch
from neutfem_tpu_torch import bench
block = int(sys.argv[1])
if block:
    from neutfem_tpu_torch import krylov
    krylov.BLOCK_ITERS = block

def switched(fn, *args, **switches):
    with bench.env(**switches):
        return fn(*args)

for row in sys.argv[2:]:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = eval({rows!r}[row])
    det = res["detail"]
    print("ROW " + json.dumps({{
        "row": row, "ms_per_outer": res["value"] * 1e3,
        "outers": det["outer_iterations"], "inners": det["inner_iterations"],
        "keff": det.get("keff", det.get("keff_adjoint")),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "cg": det.get("cg")}}), flush=True)
"""


def main(trees, order: str, rows, timeout: float = 1800.0) -> dict:
    """``trees``: label -> (directory, block size or 0 for the tree's own)."""
    summary = {label: {row: [] for row in rows} for label in trees}
    for label in order:
        path, block = trees[label]
        path = os.path.abspath(path)
        env = dict(os.environ, PYTHONPATH=path)
        proc = subprocess.run([sys.executable, "-c", _PASS.format(rows=ROWS), str(block), *rows],
                              cwd=path, env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise RuntimeError(f"compare_trees: the pass of tree {label} ({path}) failed")
        for line in proc.stdout.splitlines():
            if line.startswith("ROW "):
                res = json.loads(line[4:])
                res["tree"], res["block_iters"] = label, block or None
                print(json.dumps(res), flush=True)
                summary[label][res["row"]].append(res["ms_per_outer"])
    out = {"metric": "compare_trees_ms_per_outer", "order": order,
           "trees": {k: [os.path.abspath(p), b or None] for k, (p, b) in trees.items()},
           "ms_per_outer": summary}
    print(json.dumps(out))
    return out


def _tree(spec: str):
    label, path = spec.split("=", 1)
    head, _, tail = path.rpartition(":")
    return label, ((head, int(tail)) if head and tail.isdigit() else (path, 0))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=DIR[:K], a checkout of this repository (one letter labels)")
    ap.add_argument("--order", required=True, help="the passes, e.g. PCCP")
    ap.add_argument("--rows", default="main,ho2,zion2d,scale,adjoint",
                    help=f"comma-separated rows of {sorted(ROWS)}")
    a = ap.parse_args()
    trees = dict(_tree(t) for t in a.tree)
    rows = a.rows.split(",")
    if any(r not in ROWS for r in rows) or any(c not in trees for c in a.order):
        ap.error("unknown row or tree label")
    main(trees, a.order, rows)
