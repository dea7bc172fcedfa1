"""Where the time of one k-eff solve goes on the GPU (torch.profiler).

    python -m neutfem_tpu_torch.trace_solve [N [M]] [--order K | --core CORE | --scale |
                                            --sweep jacobi | --adjoint | --periodic |
                                            --bicgstab] [--out DIR]

Builds IAEA-3D at NxN per assembly and M axial subdivisions (default 6x6x4,
RT0-P0; with ``--order K`` RT_k-P_k, default 4x4x2, at the higher-order rows'
tolerances; with ``--scale`` 8x8x8, the line-preconditioner row), or a fine
2D core with ``--core koeberg2d|zion2d`` (default 32x32 / 48x48, with the
two-grid coarse level), float32.  The solve traced is ``SolveKeff`` from a
cold flux; with ``--sweep jacobi`` the Jacobi group sweep at
``bench.SWEEP_TOL`` (``bench.main_sweep``), with ``--adjoint`` the
free-running ``SolveAdjoint`` from a cold adjoint flux (``bench.py
--full``'s adjoint row), with ``--periodic`` ``SolveKeff`` with the four
lateral faces PERIODIC (x and y run the unfused cyclic chain on K4), with
``--bicgstab`` ``power_iteration(inner_solver="bicgstab")`` at
``bench.SWEEP_TOL`` and float64 (``bench.main_variants``' rows: from the flat
flux its float32 dots overflow on IAEA-3D, as in the JAX package).  Prints the context and two-grid build
seconds, runs one warm-up solve, one untimed-by-the-profiler solve (the
end-to-end wall) and one solve under ``torch.profiler``.  Prints the device
time per kernel family, the device busy share of the traced wall, the
tracing overhead (traced minus untraced wall), the traced solve's CG
host reads per iteration and graph replays per CG solve (``bench.cg_counts``) and
its record of the port's spans and counters (``tracing.collect``: the host's
waits on the device by synchronisation site, their share of the traced wall,
and the CG iterations the blocks ran against the live ones); with
``--out DIR`` it also writes the Chrome trace to ``DIR/solve_trace.json``.  The last line is a JSON
summary.  Needs a CUDA device.  The opt-in switches apply as in a solve:
``NEUTFEM_EQFOLD=2 python -m neutfem_tpu_torch.trace_solve`` traces K7,
``NEUTFEM_BLKFP8=0 NEUTFEM_BLOCKJAC=1 ... --order 2`` traces K8 on the bf16
inverse (the default ``--order K`` runs it on the fp8 E-form).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from . import tracing
from .bench import (FULL_TOL, HO_TOL, LATERAL, SWEEP_TOL, BenchmarkRun, cg_counts,
                    reset_cg_counts)
from .compat import BCType
from .data import BENCHMARKS
from .power import power_iteration

# kernel-name fragment -> family (first match wins)
FAMILIES = (
    ("fused_z_rows_batched_kernel", "tiled batched fused Schur direction z (K1 batch)"),
    ("fused_z_rows_kernel", "tiled fused Schur direction z (K1)"),
    ("fused_rows_batched_kernel", "tiled batched fused Schur directions y, x (K5)"),
    ("fused_rows_kernel", "tiled fused Schur directions y, x (K2, K3)"),
    ("fused_ho_rows_kernel", "tiled condensed Schur directions (K6)"),
    ("thomas_wide_rows_kernel", "tiled Thomas solve, few long lines (K4′)"),
    ("thomas_rows_kernel", "tiled Thomas solve (K4)"),
    ("fused_eq_rows_kernel", "tiled equilibration-folded Schur directions (K7)"),
    ("blockjac_dev_kernel", "tiled block-Jacobi apply + dots, fp8 E-form (K8, default)"),
    ("blockjac_tiled_kernel", "tiled block-Jacobi apply + dots, inverse (K8, BLOCKJAC=1)"),
    ("cg_step_", "masked CG step: x, r and p updates, 0-d state (cg_xr, cg_p)"),
    ("gemv", "gemv (block-Jacobi apply; two-grid coarse apply)"),
    ("nvjet", "gemv (block-Jacobi apply; two-grid coarse apply)"),  # cuBLAS's Hopper kernels
    ("reduce_kernel", "reductions (dot products, norms)"),
    ("elementwise", "elementwise (axpy, scaling, C*v)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def _family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "other"


def _solver_run(s, mode: str):
    """One solve of ``mode`` ("keff", "jacobi", "adjoint", "bicgstab") from a
    cold flux: returns (wall seconds, outers, inners)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode in ("jacobi", "bicgstab"):
        opts = dataclasses.replace(s._opts(), **({"sweep": "jacobi"} if mode == "jacobi"
                                                 else {"inner_solver": "bicgstab"}))
        res = power_iteration(s._fes, s._ng, opts, s._ctx, s._flat_phi(), 1.0)
        counts = (res["outer_iterations"], res["inner_iterations"])
    elif mode == "adjoint":
        s._phi_adj = None
        s.SolveAdjoint(use_direct_keff=False)
        hist = s.get_iteration_history()
        counts = (len(hist), int(hist[:, 3].sum()))
    else:
        s.reset_flux()
        s.SolveKeff()
        counts = (s._last_outers, s._last_inners)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, *counts)


def main(mesh_n: int = 6, mesh_nz: int = 4, out_dir=None, dtype=torch.float32,
         order: int = 0, core: str = "iaea3d", mode: str = "keff",
         periodic: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("trace_solve: no CUDA device available")
    spec = BENCHMARKS[core]
    bc = {f: (BCType.PERIODIC, 0.0) for f in LATERAL} if periodic else None
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, device="cuda", dtype=dtype,
                       rt_order=order, bc=bc)
    s = run.solver
    print(f"build seconds: {s.build_seconds}; preconditioner {s.preconditioner()}")
    run.solve(tol=HO_TOL if order else FULL_TOL)  # warm-up (and the adjoint's direct k)
    if mode in ("jacobi", "bicgstab"):
        s.set_tol(*SWEEP_TOL)
    wall, outers, inners = _solver_run(s, mode)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reset_cg_counts()
    with torch.profiler.profile(activities=acts) as prof, tracing.collect() as rec:
        wall_traced = _solver_run(s, mode)[0]
    cg = cg_counts()
    syncs = {name[len(tracing.SYNC):]: n for name, (n, _) in rec.record["spans"].items()
             if name.startswith(tracing.SYNC)}
    wait_s = sum(sec for name, (_, sec) in rec.record["spans"].items()
                 if name.startswith(tracing.SYNC))
    ran = rec.record["counters"].get("cg.iterations_run", 0)
    live = rec.record["counters"].get("cg.iterations", 0)

    fam_us, fam_n, kernels = {}, {}, {}
    for e in prof.key_averages():
        # the profiler mirrors each span (``tracing``) onto the device's
        # timeline as a user annotation: not device work
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or e.key.startswith("neutfem.")):
            continue
        us = e.self_device_time_total
        f = _family(e.key)
        fam_us[f] = fam_us.get(f, 0.0) + us
        fam_n[f] = fam_n.get(f, 0) + e.count
        kernels[e.key] = (us, e.count)
    busy_s = sum(fam_us.values()) / 1e6

    card = torch.cuda.get_device_name(0)
    mesh = f"{mesh_n}x{mesh_n}" + (f"x{mesh_nz}" if spec.dim == 3 else "")
    print(f"{core} {mesh} RT{order}-P{order} {mode}{' periodic' if periodic else ''} {dtype}: "
          f"{outers} outers, {inners} inners, "
          f"wall {wall * 1e3:.3f} ms (traced {wall_traced * 1e3:.3f} ms), {card}")
    reads_per_it = cg["host_reads"] / max(cg["iterations"], 1)
    replays_per_solve = cg["replays"] / max(cg["solves"], 1)
    print(f"device busy {100 * busy_s / wall_traced:.1f}% of the traced wall; CG: "
          f"{cg['solves']} solves, {cg['iterations']} iterations, {cg['host_reads']} host reads "
          f"({reads_per_it:.3f} per iteration), {cg['replays']} graph replays "
          f"({replays_per_solve:.2f} per solve), {cg['captures']} captures")
    print(f"host waits on the device: {sum(syncs.values())} ({syncs}), "
          f"{wait_s * 1e3:.3f} ms = {100 * wait_s / wall_traced:.1f}% of the traced wall; "
          f"CG iterations run {ran}, live {live}, frozen tail "
          f"{100 * (ran - live) / max(ran, 1):.2f}%")
    print(f"{'family':40s} {'launches':>9s} {'device ms':>10s} {'% busy':>7s} {'us/launch':>10s}")
    for f, us in sorted(fam_us.items(), key=lambda kv: -kv[1]):
        print(f"{f:40s} {fam_n[f]:9d} {us / 1e3:10.3f} {100 * us / 1e6 / busy_s:7.2f} "
              f"{us / max(fam_n[f], 1):10.2f}")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.3f} ms {n:7d}x  {name[:110]}")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "solve_trace.json"))
    summary = {
        "core": core, "mesh": mesh, "order": order, "solve": mode, "periodic": periodic,
        "dtype": str(dtype),
        "device": card, "preconditioner": s.preconditioner(),
        "build_s": s.build_seconds,
        "outers": outers, "inners": inners,
        "wall_ms": wall * 1e3, "wall_traced_ms": wall_traced * 1e3,
        "device_busy_ms": busy_s * 1e3, "device_busy_share": busy_s / wall_traced,
        "ms_per_inner": wall * 1e3 / max(inners, 1),
        "cg": cg, "host_reads_per_iteration": reads_per_it,
        "graph_replays_per_solve": replays_per_solve,
        "syncs": syncs, "host_wait_ms": wait_s * 1e3,
        "cg_iterations_run": ran, "cg_iterations_live": live,
        "families_ms": {f: us / 1e3 for f, us in fam_us.items()},
        "families_launches": fam_n,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mesh_n", nargs="?", type=int, default=None)
    p.add_argument("mesh_nz", nargs="?", type=int, default=None)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--order", type=int, default=0, help="RT_k-P_k order (default 0)")
    mode.add_argument("--core", choices=("koeberg2d", "zion2d"), default=None,
                      help="a fine 2D core (default 32x32 / 48x48)")
    mode.add_argument("--scale", action="store_true", help="IAEA-3D 8x8x8 (3.5M cells)")
    mode.add_argument("--sweep", choices=("jacobi",), default=None,
                      help="trace the Jacobi group sweep (IAEA-3D, default 6x6x4)")
    mode.add_argument("--adjoint", action="store_true",
                      help="trace the free-running adjoint (IAEA-3D, default 6x6x4)")
    mode.add_argument("--periodic", action="store_true",
                      help="the lateral faces PERIODIC (IAEA-3D, default 6x6x4)")
    mode.add_argument("--bicgstab", action="store_true",
                      help="trace the BiCGSTAB inner solver (IAEA-3D, default 6x6x4)")
    p.add_argument("--out", default=None, help="directory for solve_trace.json")
    a = p.parse_args()
    if a.bicgstab:
        main(a.mesh_n or 6, a.mesh_nz or 4, a.out, dtype=torch.float64, mode="bicgstab")
    elif a.sweep or a.adjoint:
        main(a.mesh_n or 6, a.mesh_nz or 4, a.out, mode="jacobi" if a.sweep else "adjoint")
    elif a.periodic:
        main(a.mesh_n or 6, a.mesh_nz or 4, a.out, periodic=True)
    elif a.core is not None:
        main(a.mesh_n or {"koeberg2d": 32, "zion2d": 48}[a.core], 1, a.out, core=a.core)
    elif a.scale:
        main(a.mesh_n or 8, a.mesh_nz or 8, a.out)
    else:
        main(a.mesh_n or (4 if a.order else 6), a.mesh_nz or (2 if a.order else 4), a.out,
             order=a.order)
