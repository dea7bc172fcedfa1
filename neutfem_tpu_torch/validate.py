"""The literature cores against their published k_ref, and the fine 2D parity
ladder, on the PyTorch port.

Port of ``benchmarks/validate_tpu.py`` (``validate``: the five cores, each
held within a pcm bound of its literature k_ref, pcm = 1e5 (1/k_ref - 1/k))
and of ``benchmarks/parity.py`` (``run_ladder``: each 2D core over a mesh
ladder, a first solve, then one timed solve from a cold flux).  Each row also
carries the run's outer and inner counts, the kernel launches and CG counts
of its solve, the preconditioner the group solves ran and the card's name and
power limit.  Run on the card with

    python -m neutfem_tpu_torch.validate                  # the five cores
    python -m neutfem_tpu_torch.validate --ladder [--cores zion2d --meshes 64,68]

at float32, the JAX package's hardware path.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .bench import FULL_TOL, BenchmarkRun, card_line, cg_counts, launch_counts
from .data import BENCHMARKS, IAEA2D_POWER_MAP

__all__ = ["CASES", "DEFAULT_CORES", "DEFAULT_MESHES", "LADDER_TOL", "validate", "run_ladder",
           "main"]

#: (core, BenchmarkRun keywords, |pcm| bound): ``benchmarks/validate_tpu.CASES``.
#: The bounds sit just above the JAX package's measured ladder values
#: (BIBLIS 32x32 +0.3, KOEBERG 32x32 +1.2 / +1.5, ZION 48x48 +4.2 pcm) with
#: margin for float32 noise; IAEA-2D stays at 8x8, the reference's own
#: configuration (its fine meshes converge to the RT0 discretization's own
#: limit, +6.2 pcm at 32x32).
CASES = [
    ("iaea2d", dict(mesh_n=8), 2.0),
    ("biblis2d", dict(mesh_n=32), 2.0),
    ("koeberg2d", dict(mesh_n=32), 3.0),
    ("zion2d", dict(mesh_n=48), 6.0),
    ("iaea3d", dict(mesh_n=6, mesh_nz=4), 2.0),
]

#: ``benchmarks/parity.py``'s ladder and tolerances (k, flux, L2, outers, inners)
DEFAULT_CORES = ("iaea2d", "biblis2d", "koeberg2d", "zion2d")
DEFAULT_MESHES = (4, 8, 16, 32)
LADDER_TOL = (1e-6, 1e-5, 1e-5, 300, 2000)

#: the published assembly power maps a full core's ``Fass`` is held to
POWER_MAPS = {"iaea2d": IAEA2D_POWER_MAP}


def _counts() -> tuple:
    """(every kernel's launch count, the CG counts), summed so far."""
    return launch_counts(), cg_counts()


def _since(before: tuple) -> tuple:
    """(kernel launches, CG counts) since ``before``: the kernels that moved,
    and every CG count."""
    (l0, c0), (l1, c1) = before, _counts()
    return ({k: v - l0.get(k, 0) for k, v in l1.items() if v != l0.get(k, 0)},
            {k: v - c0[k] for k, v in c1.items()})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(device, what):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"validate.{what}: no CUDA device available")
    return device


def validate(cases=CASES, tol=FULL_TOL, device="cuda", dtype=torch.float32) -> list:
    """Each core of ``cases`` built and solved once at ``tol``; prints a line
    and then the JSON list of rows, one a core: name, mesh, k, k_ref, pcm,
    bound, ok, outers, inners, wall (build and solve) and solve seconds, the
    preconditioner, the solve's kernel launches and CG counts, the card, and
    for a core with a published power map the largest |deviation| of its
    assembly power factors in percent.  Raises ``SystemExit`` when a row is
    out of its bound, as ``validate_tpu.main`` does; returns the rows."""
    device = _device(device, "validate")
    card = card_line(device)
    rows = []
    for name, kw, bound in cases:
        t0 = time.time()
        run = BenchmarkRun(BENCHMARKS[name], device=device, dtype=dtype, **kw)
        s = run.solver
        _sync(device)
        before = _counts()
        run.solve(tol=tol)
        launches, cg = _since(before)
        wall = time.time() - t0
        ok = abs(run.pcm) < bound
        n = kw["mesh_n"]
        mesh = f"{n}x{n}" + (f"x{kw['mesh_nz']}" if "mesh_nz" in kw else "")
        row = dict(name=name, mesh=mesh, keff=run.keff, kref=run.spec.kref, pcm=run.pcm,
                   bound=bound, ok=bool(ok), outer_iterations=s._last_outers,
                   inner_iterations=s._last_inners, wall_s=wall, solve_s=run.solve_seconds,
                   n_cells=s.GetNumElements(), preconditioner=s.preconditioner(), cg=cg,
                   launches=launches, dtype=str(dtype), device=card)
        if name in POWER_MAPS and run.Fass is not None:
            row["power_max_dev_pct"] = float(np.nanmax(np.abs(
                run.power_deviation(POWER_MAPS[name]))))
        rows.append(row)
        print(f"{name:10s} {kw}: k={run.keff:.6f} kref={run.spec.kref} pcm={run.pcm:+.2f} "
              f"(|bound| {bound}) {'OK' if ok else 'FAIL'} [{wall:.1f}s]; "
              f"{s._last_outers} / {s._last_inners}", flush=True)
        del run, s
    print(json.dumps(rows))
    if not all(r["ok"] for r in rows):
        raise SystemExit("SOME FAILED")
    print("ALL OK")
    return rows


def run_ladder(cores=DEFAULT_CORES, meshes=DEFAULT_MESHES, rt_order=0, tol=LADDER_TOL,
               device="cuda", dtype=torch.float32) -> list:
    """Each 2D core of ``cores`` at each NxN of ``meshes``: a first solve at
    ``tol`` (build excluded), ``reset_flux``, then one timed solve from a cold
    flux (``benchmarks/parity.run_ladder``); prints one JSON row each with the
    JAX rows' keys plus the timed solve's inners, launches and CG counts, the
    preconditioner and the card, and returns the rows."""
    device = _device(device, "run_ladder")
    card = card_line(device)
    rows = []
    for name in cores:
        spec = BENCHMARKS[name]
        for n in meshes:
            run = BenchmarkRun(spec, mesh_n=n, rt_order=rt_order, verbose=False, device=device,
                               dtype=dtype)
            s = run.solver
            _sync(device)
            t0 = time.time()
            run.solve(tol=tol)  # ends in a device -> host read of k
            first = time.time() - t0
            s.reset_flux()
            _sync(device)
            before = _counts()
            t0 = time.time()
            run.keff = s.SolveKeff()
            wall = time.time() - t0
            launches, cg = _since(before)
            outers = s._last_outers
            rows.append({
                "core": name, "mesh": f"{n}x{n}", "n_cells": s.GetNumElements(), "ng": spec.ng,
                "keff": run.keff, "kref": spec.kref, "pcm": run.pcm,
                "outer_iterations": outers, "inner_iterations": s._last_inners,
                "solve_wall_s": wall, "ms_per_outer": 1e3 * wall / max(outers, 1),
                "compile_plus_first_solve_s": first, "preconditioner": s.preconditioner(),
                "cg": cg, "launches": launches, "dtype": str(dtype), "device": card,
            })
            print(json.dumps(rows[-1]), flush=True)
            del run, s
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ladder", action="store_true", help="the fine 2D parity ladder")
    p.add_argument("--cores", default=",".join(DEFAULT_CORES))
    p.add_argument("--meshes", default=",".join(map(str, DEFAULT_MESHES)))
    p.add_argument("--order", type=int, default=0, help="RT/P order of the ladder")
    p.add_argument("--json", default=None, help="also write the rows to this file")
    args = p.parse_args(argv)
    if not args.ladder:
        return validate()
    rows = run_ladder(cores=args.cores.split(","), meshes=[int(m) for m in args.meshes.split(",")],
                      rt_order=args.order)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    print("\n| core | mesh | cells | k_eff | k_ref | pcm | outers | ms/outer |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['core']} | {r['mesh']} | {r['n_cells']} | {r['keff']:.6f} | {r['kref']} "
              f"| {r['pcm']:+.2f} | {r['outer_iterations']} | {r['ms_per_outer']:.3f} |")
    return rows


if __name__ == "__main__":
    main()
