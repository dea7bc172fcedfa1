"""Where the time of one IAEA-3D solve goes on the GPU (torch.profiler).

    python -m neutfem_tpu_torch.trace_solve [N [M]] [--out DIR]

Builds IAEA-3D at NxN per assembly and M axial subdivisions (default 6x6x4,
float32), runs one warm-up solve, one untimed-by-the-profiler solve (the
end-to-end wall) and one solve under ``torch.profiler``.  Prints the device
time per kernel family, the device busy share of the traced wall and the
tracing overhead (traced minus untraced wall); with ``--out DIR`` it also
writes the Chrome trace to ``DIR/solve_trace.json``.  The last line is a JSON
summary.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .bench import BenchmarkRun, load_benchmark_data

TOL = (1e-5, 1e-4, 1e-4, 200, 1000)  # bench.main's tolerances

# kernel-name fragment -> family (first match wins)
FAMILIES = (
    ("fused_dir_kernel", "fused Schur directions (K1-K3)"),
    ("thomas_kernel", "Thomas solve (K4)"),
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


def _solve_wall(solver) -> float:
    solver.reset_flux()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.SolveKeff()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(mesh_n: int = 6, mesh_nz: int = 4, out_dir=None, dtype=torch.float32) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("trace_solve: no CUDA device available")
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, device="cuda", dtype=dtype)
    s = run.solver
    run.solve(tol=TOL)  # warm-up
    wall = _solve_wall(s)
    outers, inners = s._last_outers, s._last_inners

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_traced = _solve_wall(s)

    fam_us, fam_n, kernels = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        f = _family(e.key)
        fam_us[f] = fam_us.get(f, 0.0) + us
        fam_n[f] = fam_n.get(f, 0) + e.count
        kernels[e.key] = (us, e.count)
    busy_s = sum(fam_us.values()) / 1e6

    card = torch.cuda.get_device_name(0)
    print(f"IAEA-3D {mesh_n}x{mesh_n}x{mesh_nz} {dtype}: {outers} outers, {inners} inners, "
          f"wall {wall * 1e3:.3f} ms (traced {wall_traced * 1e3:.3f} ms), {card}")
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
        "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}", "dtype": str(dtype), "device": card,
        "outers": outers, "inners": inners,
        "wall_ms": wall * 1e3, "wall_traced_ms": wall_traced * 1e3,
        "device_busy_ms": busy_s * 1e3, "device_busy_share": busy_s / wall_traced,
        "ms_per_inner": wall * 1e3 / max(inners, 1),
        "families_ms": {f: us / 1e3 for f, us in fam_us.items()},
        "families_launches": fam_n,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mesh_n", nargs="?", type=int, default=6)
    p.add_argument("mesh_nz", nargs="?", type=int, default=4)
    p.add_argument("--out", default=None, help="directory for solve_trace.json")
    a = p.parse_args()
    main(a.mesh_n, a.mesh_nz, a.out)
