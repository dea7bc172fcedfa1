"""Scaling ladder: IAEA-3D seconds per outer iteration against the cell count.

Port of ``benchmarks/scaling.py``.  Each row builds IAEA-3D at NxN per
assembly and M axial subdivisions per plane (RT0-P0, two groups), solves once
at ``bench.FULL_TOL``, calls ``reset_flux`` and times one more solve from the
cold flux (it ends in a device -> host read of k).  The row holds the JAX
row's keys but its TPU-only ``axis_perm`` (the port keeps the mesh in its own
axis order), plus k before its rounding to 7 digits (``keff_unrounded``: a
float64 solve is held to 1e-9), the device, the dtype, the preconditioner
"auto" resolved to, the timed solve's CG counts and kernel launches, and on
the card the peak device memory of the row.  From the second row on, ``per_doubling`` is the
growth of s/outer for each doubling of the cell count.

Run on the card with

    python -m neutfem_tpu_torch.scaling [--x64] [--meshes 2x2x2,4x4x3,6x6x4,8x8x6,8x8x8]
        [--device cuda|cpu]

``--x64`` solves in float64 (the card has it natively), else float32.  One
JSON line a row.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional, Sequence

import torch

from .bench import _cg_detail, _device_name, _timed_run
from .data import BENCHMARKS

__all__ = ["DEFAULT_MESHES", "run_one", "per_doubling", "main"]

DEFAULT_MESHES = "2x2x2,4x4x3,6x6x4,8x8x6,8x8x8"


def run_one(mesh_n: int, mesh_nz: int, device="cuda", dtype=torch.float32) -> dict:
    """One row of the ladder (``benchmarks/scaling.py:31-58``): build, a
    warm-up solve at ``bench.FULL_TOL``, ``reset_flux``, one timed solve."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(device)
    spec = BENCHMARKS["iaea3d"]
    run, keff, wall, launches = _timed_run(spec, "scaling.run_one", device, dtype,
                                           mesh_n=mesh_n, mesh_nz=mesh_nz)
    s = run.solver
    outers = s._last_outers
    return {
        "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
        "n_cells": s.GetNumElements(),
        "keff": round(float(keff), 7),
        "keff_unrounded": float(keff),
        "pcm": round(float(1e5 * (1.0 / spec.kref - 1.0 / keff)), 2),
        "outers": int(outers),
        "inners": int(s._last_inners),
        "wall_s": round(wall, 3),
        "s_per_outer": round(wall / max(outers, 1), 5),
        "device": _device_name(device),
        "dtype": str(s._dtype),
        "preconditioner": s.preconditioner(),
        "cg": _cg_detail(),
        "launches": launches,
        "peak_mem_gb": (round(torch.cuda.max_memory_allocated(device) / 1e9, 3)
                        if device.type == "cuda" else None),
    }


def per_doubling(prev: dict, row: dict) -> Optional[float]:
    """Growth of s/outer per doubling of the cell count from ``prev`` to
    ``row`` (``benchmarks/scaling.py:83-89``); None where either time is 0."""
    if not (row["s_per_outer"] > 0 and prev["s_per_outer"] > 0):
        return None
    ratio_cells = row["n_cells"] / prev["n_cells"]
    ratio_t = row["s_per_outer"] / prev["s_per_outer"]
    return round(ratio_t ** (1.0 / math.log2(ratio_cells)), 3)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """The ladder's CLI; prints one JSON line a row and returns the rows."""
    ap = argparse.ArgumentParser(description="IAEA-3D scaling ladder (PyTorch port)")
    ap.add_argument("--x64", action="store_true", help="solve in float64 (default float32)")
    ap.add_argument("--meshes", default=DEFAULT_MESHES,
                    help="comma list of NxN[xNZ] IAEA-3D mesh configs")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dtype = torch.float64 if args.x64 else torch.float32
    meshes = []
    for tok in args.meshes.split(","):
        parts = [int(p) for p in tok.split("x")]
        if len(parts) >= 2 and parts[1] != parts[0]:
            raise SystemExit(
                f"--meshes token {tok!r}: the horizontal subdivision must be square "
                f"(NxNxNZ, got {parts[0]}x{parts[1]} in-plane)")
        meshes.append((parts[0], parts[2] if len(parts) > 2 else parts[0]))
    rows, prev = [], None
    for n, nz in meshes:
        row = run_one(n, nz, device=args.device, dtype=dtype)
        if prev is not None:
            growth = per_doubling(prev, row)
            if growth is not None:
                row["per_doubling"] = growth
        print(json.dumps(row), flush=True)
        rows.append(row)
        prev = row
    return rows


if __name__ == "__main__":
    main()
