"""Per-core entry point of the literature benchmarks on the PyTorch port.

Port of ``benchmarks/runner.py``'s ``run_benchmark`` and ``main``, the
counterparts of the reference's five benchmark scripts (layout expansion,
optional quarter / half domain, per-cell cross sections, ``BuildMatrices``,
``SolveKeff`` [+ ``SolveAdjoint``], pcm against k_ref, assembly power
factors).  Run on the card with

    python -m neutfem_tpu_torch.runner <core> [--mesh NxN] [--mesh-z M] [--domain D]
        [--order K | --rt-order K --p-order M] [--adjoint] [--coarse] [--cmfd] [--diag]
        [--vtk BASENAME] [--verbose] [--device cuda|cpu]

where ``<core>`` is one of ``iaea2d``, ``iaea3d``, ``biblis2d``, ``koeberg2d``
and ``zion2d``.  The dtype follows ``NEUTFEM_X64`` (float64 unless it is 0),
as the JAX runner's does.  The JAX runner's ``--plot`` is not ported.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

from .bench import FULL_TOL, BenchmarkRun
from .coarse import default_coarse_factors
from .data import BENCHMARKS

__all__ = ["run_benchmark", "main"]


def run_benchmark(name: str, mesh_n: int = 2, mesh_nz: int = 1, domain: str = "entier",
                  adjoint: bool = False, use_coarse_init: bool = False, coarse_factors=(),
                  tol=FULL_TOL, verbose: bool = False, use_cmfd: bool = False,
                  use_diagonal_solver: bool = False, rt_order: int = 0,
                  p_order: Optional[int] = None, device="cuda", dtype=None) -> BenchmarkRun:
    """Build core ``name`` and solve it once with the JAX runner's options;
    returns the run (k, k_adj, Fass, pcm)."""
    run = BenchmarkRun(BENCHMARKS[name], mesh_n=mesh_n, mesh_nz=mesh_nz, domain=domain,
                       verbose=verbose, device=device, dtype=dtype, rt_order=rt_order,
                       p_order=p_order)
    run.solve(tol=tol, adjoint=adjoint, use_coarse_init=use_coarse_init,
              coarse_factors=coarse_factors, use_cmfd=use_cmfd,
              use_diagonal_solver=use_diagonal_solver)
    return run


def main(name: str, argv: Optional[Sequence[str]] = None) -> BenchmarkRun:
    """The JAX runner's CLI for core ``name``, plus ``--device``; prints its
    lines (k with k_ref and pcm, then the adjoint and assembly-power lines
    where they apply) and returns the run."""
    p = argparse.ArgumentParser(description=f"{name} benchmark (NeutFEM, PyTorch port)")
    p.add_argument("--mesh", default="2x2", help="NxN subdivision per assembly")
    p.add_argument("--mesh-z", type=int, default=1, help="axial subdivisions per plane (3D)")
    p.add_argument("--domain", default="entier")
    p.add_argument("--order", type=int, default=None, help="RT_k-P_k order")
    p.add_argument("--rt-order", type=int, default=0)
    p.add_argument("--p-order", type=int, default=None)
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--coarse", action="store_true", help="use coarse-grid init")
    p.add_argument("--cmfd", action="store_true")
    p.add_argument("--diag", action="store_true", help="reference diagonal-Schur mode")
    p.add_argument("--vtk", default=None, help="export VTK to this basename")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)

    n = int(str(args.mesh).split("x")[0])
    spec = BENCHMARKS[name]
    rt = args.order if args.order is not None else args.rt_order
    po = args.order if args.order is not None else args.p_order
    run = BenchmarkRun(spec, mesh_n=n, mesh_nz=args.mesh_z, domain=args.domain,
                       verbose=args.verbose, device=args.device, rt_order=rt, p_order=po)
    cf = list(default_coarse_factors(run.solver._mesh)) if args.coarse else ()
    t0 = time.time()
    run.solve(adjoint=args.adjoint, use_coarse_init=args.coarse, coarse_factors=cf,
              use_cmfd=args.cmfd, use_diagonal_solver=args.diag)
    wall = time.time() - t0

    print(f"{name}: k-eff = {run.keff:.6f}  (k_ref = {spec.kref})  "
          f"pcm = {run.pcm:+.2f}  wall = {wall:.2f}s")
    if run.keff_adj is not None:
        print(f"  adjoint k-eff = {run.keff_adj:.6f}  |k-k_adj| = "
              f"{abs(run.keff - run.keff_adj):.2e}")
    if run.Fass is not None:
        print(f"  assembly power factors: max = {np.nanmax(run.Fass):.4f}")
    if args.vtk:
        run.solver.ExportVTK(args.vtk, export_flux=True, export_current=True,
                             export_xs=True, export_adjoint=args.adjoint)
        print(f"  VTK written to {args.vtk}.vtk")
    return run


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in BENCHMARKS:
        raise SystemExit(f"usage: python -m neutfem_tpu_torch.runner {{{','.join(BENCHMARKS)}}} "
                         "[options]  (--help after the core lists them)")
    main(sys.argv[1], sys.argv[2:])
