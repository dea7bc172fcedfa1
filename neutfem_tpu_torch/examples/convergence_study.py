"""IAEA-2D convergence study: mesh refinement (RT0) against order refinement
(RT1, RT2).

The port of ``examples/convergence_study.py``: IAEA-2D at RT0 1x1, 2x2 and
4x4 cells per assembly and at RT1 1x1, 2x2 and RT2 1x1, each solved at
``TOL``; one line each with k, pcm against k_ref and the outer count.
``python -m neutfem_tpu_torch.examples.convergence_study [--device cpu]``.
"""

from __future__ import annotations

import argparse

from ..bench import BenchmarkRun
from ..data import BENCHMARKS

#: the example's tolerances (k, flux, L2, outers, inners)
TOL = (1e-6, 1e-5, 1e-5, 300, 2000)
#: (label, cells per assembly, RT order)
CONFIGS = (("RT0 1x1", 1, 0), ("RT0 2x2", 2, 0), ("RT0 4x4", 4, 0),
           ("RT1 1x1", 1, 1), ("RT1 2x2", 2, 1), ("RT2 1x1", 1, 2))


def main(device="cuda", dtype=None, configs=CONFIGS) -> list:
    """Solve each configuration; prints the example's table and returns its
    rows as dicts (label, keff, pcm, outers)."""
    rows = []
    print(f"{'config':>16} {'k-eff':>10} {'pcm':>9} {'outers':>7}")
    for label, n, rt in configs:
        run = BenchmarkRun(BENCHMARKS["iaea2d"], mesh_n=n, rt_order=rt, device=device,
                           dtype=dtype)
        run.solve(tol=TOL)
        outers = run.solver._last_outers
        print(f"{label:>16} {run.keff:10.6f} {run.pcm:+9.2f} {outers:7d}")
        rows.append({"label": label, "keff": run.keff, "pcm": run.pcm, "outers": outers})
        del run
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
