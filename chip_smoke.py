"""Smoke test of the PyTorch port (neutfem_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result prints):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the main path's
   operands (IAEA-3D 6x6x4, 76x114x114 cells, group 0, float32), with times;
4. reference: the IAEA-3D 1x1 solve at float64 on the GPU agrees with the same
   solve through the plain versions on the CPU;
5. main path: ``neutfem_tpu_torch.bench.main(6, 4)`` (float32), checked
   against the parity anchors of the JAX package's benchmark (k 1.029104,
   34 outers, 1068 inners), with every kernel's launch count > 0.

The last two lines are a JSON object of per-kernel results and the contract
line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

KEFF_ANCHOR, KEFF_TOL = 1.029104, 1e-5
OUTERS_ANCHOR, OUTERS_TOL = 34, 3
INNERS_ANCHOR, INNERS_REL = 1068, 0.15
KERNEL_REL_TOL = 1e-5  # float32, FMA contraction in the kernels vs the plain recurrence


def _timed(fn, reps):
    """Mean milliseconds per call over ``reps`` calls (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _compare(name, got, want, base):
    """max |got - want| and its size relative to the contribution want - base."""
    import torch

    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want - base)))
    rel = err / scale if scale > 0 else err
    print(f"  {name}: max_abs_err {err:.3e}  rel {rel:.3e}")
    if not rel <= KERNEL_REL_TOL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version (rel {rel:.3e})")
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU")
    os.environ.setdefault("NEUTFEM_X64", "0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    import numpy as np

    from neutfem_tpu_torch import bench
    from neutfem_tpu_torch.ops import cuda_lib, fused, thomas
    from neutfem_tpu_torch.ops.apply import apply_BT_dir
    from neutfem_tpu_torch.power import ctx_group

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.build_info['seconds']:.2f} s)")
    for line in cuda_lib.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    {line.strip()}")

    dev = torch.device("cuda")
    f32 = torch.float32
    spec = bench.load_benchmark_data().BENCHMARKS["iaea3d"]
    run = bench.BenchmarkRun(spec, mesh_n=6, mesh_nz=4, device=dev, dtype=f32)
    fes, ctx = run.solver._fes, run.solver._ctx
    ctxg = ctx_group(ctx, 0)
    rng = np.random.default_rng(0)
    shape = (1, *fes.mesh.shape)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
    acc0 = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
    print(f"[3] kernels vs plain, IAEA-3D 6x6x4 {fes.mesh.shape} group 0, float32 ({card})")

    dirs = {di.d: di for di in fes.dirs}
    rows = {}
    cases = [  # (id, key, wrapper, staged dm, staged l, natural axis, TPU kernel)
        ("K1", "z", fused.fused_schur_z, "tri_dinvm_d2", "tri_l_d2", -3,
         "neutfem_tpu/ops/pallas_fused.py:466"),
        ("K2", "y", fused.fused_schur_y_pre, "tri_yT_dinvm_d1", "tri_yT_l_d1", -2,
         "neutfem_tpu/ops/pallas_fused.py:518"),
        ("K3", "x", fused.fused_schur_x_pre, "tri_xT_dinvm_d0", "tri_xT_l_d0", -1,
         "neutfem_tpu/ops/pallas_fused.py:547"),
    ]
    for kid, key, wrapper, dm_key, l_key, axis, replaces in cases:
        d = {"z": 2, "y": 1, "x": 0}[key]
        di = dirs[d]
        bx0, bx1, si = float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0])
        got = wrapper(acc0.clone(), v, ctxg[dm_key], ctxg[l_key], bx0, bx1, si)
        # the plain version reads the NATURAL (unstaged) operands: a wrong
        # staging base or stride in the kernel shows up here
        want = fused.fused_dir_plain(acc0, v, ctxg[f"tri_dinvm_d{d}"], ctxg[f"tri_l_d{d}"],
                                     axis, bx0, bx1, si)
        torch.cuda.synchronize()
        err = _compare(f"{kid} fused {key}", got, want, acc0)
        scratch = acc0.clone()
        ms = _timed(lambda: wrapper(scratch, v, ctxg[dm_key], ctxg[l_key], bx0, bx1, si), 50)
        plain_ms = _timed(lambda: fused.fused_dir_plain(
            acc0, v, ctxg[f"tri_dinvm_d{d}"], ctxg[f"tri_l_d{d}"], axis, bx0, bx1, si), 3)
        print(f"  {kid} fused {key}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  ({card})")
        rows[kid] = {"name": f"{kid} fused Schur direction {key}", "route": "cuda",
                     "source": "neutfem_tpu_torch/csrc/fused_dir.cu", "replaces": replaces,
                     "key": key, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # K4 at the three compute_current layouts: rhs (2, 1, faces...) per direction
    phi = torch.as_tensor(rng.standard_normal((2, *shape)), dtype=f32, device=dev)
    k4_err, k4_ms, k4_plain = 0.0, 0.0, 0.0
    for di in fes.dirs:
        key = f"d{di.d}"
        rF, _ = apply_BT_dir(fes, di, phi)
        rFs = (rF * ctx[f"mask_{key}"]) / float(di.m_t[0])
        dinv = ctx[f"tri_dinv_{key}"].unsqueeze(-4).expand(rFs.shape).contiguous()
        lsh = list(rFs.shape)
        lsh[di.axis - 3] -= 1
        lf = ctx[f"tri_l_{key}"].unsqueeze(-4).expand(lsh).contiguous()
        ax = di.axis - 3
        got = thomas.thomas_solve(rFs, dinv, lf, ax)
        want = thomas.thomas_solve_plain(rFs, dinv, lf, ax)
        torch.cuda.synchronize()
        err = _compare(f"K4 thomas {tuple(rFs.shape)} axis {ax}", got, want,
                       torch.zeros_like(want))
        ms = _timed(lambda: thomas.thomas_solve(rFs, dinv, lf, ax), 50)
        plain_ms = _timed(lambda: thomas.thomas_solve_plain(rFs, dinv, lf, ax), 3)
        print(f"  K4 thomas axis {ax}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  ({card})")
        k4_err, k4_ms, k4_plain = max(k4_err, err), k4_ms + ms, k4_plain + plain_ms
    rows["K4"] = {"name": "K4 batched Thomas solve (_solve_z/_solve_rows/_solve_transpose; "
                          "times summed over the three compute_current layouts)",
                  "route": "cuda", "source": "neutfem_tpu_torch/csrc/thomas.cu",
                  "replaces": "neutfem_tpu/ops/pallas_tridiag.py:181", "key": "thomas",
                  "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain}
    del run, ctx, ctxg

    # [4] small input: the GPU (kernels) against the CPU (plain versions), float64
    small = {}
    for device in ("cpu", "cuda"):
        r = bench.BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device=device, dtype=torch.float64)
        k = r.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
        phi_out = r.solver._phi
        if tuple(phi_out.shape) != (2, 19, 19, 19, 1) or not bool(torch.isfinite(phi_out).all()):
            raise RuntimeError(f"IAEA-3D 1x1 on {device}: bad flux {tuple(phi_out.shape)}")
        small[device] = (k, r.solver._last_outers, r.solver._last_inners)
    print(f"[4] IAEA-3D 1x1 float64: cuda {small['cuda']}  cpu {small['cpu']}")
    if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
            or small["cuda"][1] != small["cpu"][1]
            or abs(small["cuda"][2] - small["cpu"][2]) > 2):
        raise RuntimeError("IAEA-3D 1x1: the GPU solve disagrees with the CPU reference")

    # [5] the main path; counts are zeroed just before it and read just after
    fused.reset_launches()
    thomas.reset_launches()
    print("[5] main path: neutfem_tpu_torch.bench.main(6, 4), float32")
    res = bench.main(6, 4)
    launches = {**fused.LAUNCHES, **thomas.LAUNCHES}
    print(f"    launches {launches}")
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff} (anchor {KEFF_ANCHOR}), outers {outers} ({OUTERS_ANCHOR}), "
          f"inners {inners} ({INNERS_ANCHOR}); {res['value'] * 1e3:.3f} ms/outer ({card})")
    if not abs(keff - KEFF_ANCHOR) <= KEFF_TOL:
        raise RuntimeError(f"keff {keff} is not within {KEFF_TOL} of {KEFF_ANCHOR}")
    if not abs(outers - OUTERS_ANCHOR) <= OUTERS_TOL:
        raise RuntimeError(f"{outers} outers, expected {OUTERS_ANCHOR} +- {OUTERS_TOL}")
    if not abs(inners - INNERS_ANCHOR) <= INNERS_REL * INNERS_ANCHOR:
        raise RuntimeError(f"{inners} inners, expected {INNERS_ANCHOR} +- 15%")
    for row in rows.values():
        row["launches"] = launches[row.pop("key")]
        if row["launches"] <= 0:
            raise RuntimeError(f"{row['name']}: not launched on the main path")

    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
