"""How far rounding in the condensed Schur directions (K6) and in the block
preconditioner (K8) moves a solve's counts; and, with ``--accel``, how far it
moves the accelerator matrix's (``accel_probe``).

Run on the GPU from the root of the repository:

    python -m neutfem_tpu_torch.rounding_probe [--accel]

One IAEA-3D 4x4x2 RT2-P2 float32 context with bfloat16 block storage
(``NEUTFEM_BLKFP8=0``), solved at ``bench.HO_TOL`` from a cold flux with the
default block apply and with ``NEUTFEM_BLOCKJAC=1`` (K8), once per K6 variant:

* the tiled kernel (``csrc/fused_ho_rows.cu``) at the tile ``ho_tile`` picks,
  and at 16 lines x 4 chunks x 1 mode, which cuts the chunks elsewhere;
* the thread-per-(mode, line) kernel it replaced (``csrc/fused_ho.cu``), with
  its contribution to the accumulator scaled by 1, 1 +- 1e-7 and 1 + 1e-6,
  i.e. moved by about one float32 rounding.

And one with the default fp8 E-form storage, its blocks applied by K8
(``blockjac_dev_dots``, the default) or by the apply the port ran before K8
took the E-form (``power._block_precond``: ``torch.bmm`` on a float32 copy,
the dots as ``torch.sum``), each with the tiled K6 and with the old K6
scaled by 1 +- 1e-7.

Prints one JSON line per solve: the variant, k, outers and inners, the first
outer whose flux change is below ``tol_flux``, and the last outers' k changes
in units of k's float32 spacing (``HO_TOL``'s ``tol_keff`` = 1e-7 is below one
spacing of k near 1.03, 1.19e-7, so the solve stops only on an outer whose k
repeats bit for bit).  Every variant computes the same operators up to
float32 rounding (``chip_smoke.py`` [3] holds each kernel to its plain
version at 1e-5), so a spread in the counts is the solve's sensitivity to
rounding, not a kernel's error.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import bench, power
from .ops import cuda_lib, fused_ho


def _old_kernel(scale):
    """A stand-in for ``fused_ho._launch`` that runs the thread-per-(mode,
    line) kernel and scales its contribution by ``scale``."""

    def launch(acc, v, dm, l, alpha, tables, n, lines, inner, outer_stride, cell_stride, axis,
               key):
        K1 = tables.K1
        tab = torch.as_tensor(tables.packed(), dtype=v.dtype, device=v.device)
        zs = torch.empty((K1 * K1, n, lines), dtype=v.dtype, device=v.device)
        base = acc.clone() if scale != 1.0 else None
        fn = cuda_lib.library().neutfem_fused_ho_f32
        cuda_lib.check(fn(acc.data_ptr(), v.data_ptr(), dm.data_ptr(), l.data_ptr(),
                          alpha.data_ptr(), tab.data_ptr(), zs.data_ptr(), K1, 2 - axis, n,
                          lines, inner, outer_stride, cell_stride, v.shape[-3:].numel(),
                          torch.cuda.current_stream(v.device).cuda_stream), "fused_ho")
        if base is not None:
            acc.copy_(base + (acc - base) * scale)
        return acc

    return launch


def _bmm_route():
    """A stand-in for ``power.blockjac_dev_dots``: the E-form applied by
    ``power._block_precond`` (its float32 copy made once per block tensor),
    the dots as ``torch.sum``, as ``pcg`` forms them without K8."""
    applies = {}

    def dots(dev, r):
        key = dev.data_ptr()
        if key not in applies:
            applies[key] = power._block_precond({"precond_blk_dev": dev}, r.dtype)
        z = applies[key](r)
        return z, torch.sum(r * z), torch.sum(r * r)

    return dots


def _tail(s, tol_flux: float) -> dict:
    """Where the solve's stop criteria sat: the first outer whose flux change
    is below ``tol_flux``, and the last 6 outers' |dk| over k's float32
    spacing."""
    hist = np.asarray(s.get_iteration_history(), dtype=np.float64)
    below = np.nonzero(hist[:, 2] < tol_flux)[0]
    ulp = float(np.spacing(np.float32(hist[-1, 0])))
    return {"first_outer_dphi_below_tol": int(below[0]) + 1 if below.size else None,
            "dk_over_k_spacing_last": [round(float(d) / ulp, 2) for d in hist[-6:, 1]]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rounding_probe: needs a CUDA device")
    spec = bench.load_benchmark_data().BENCHMARKS["iaea3d"]
    runs = {}
    for storage, fp8 in (("bf16", "0"), ("fp8", "1")):
        with bench.env(NEUTFEM_BLKFP8=fp8):
            runs[storage] = bench.BenchmarkRun(spec, 4, 2, device="cuda", dtype=torch.float32,
                                               rt_order=2)
    tiled, tile = fused_ho._launch, fused_ho.ho_tile
    variants = [("tiled, ho_tile", tiled, tile),
                ("tiled, 16x4x1", tiled, lambda lines, n, K1, dtype: (16, 4, 1))]
    variants += [(f"thread-per-(mode, line) x {s!r}", _old_kernel(s), tile)
                 for s in (1.0, 1.0 + 1e-7, 1.0 - 1e-7, 1.0 + 1e-6)]
    cases = [("bf16", v, sw, "K8" if sw else "_block_precond") for v in variants
             for sw in ({}, {"NEUTFEM_BLOCKJAC": "1"})]
    cases += [("fp8", v, {}, apply) for apply in ("K8", "_block_precond")
              for v in [variants[0]] + [(f"thread-per-(mode, line) x {s!r}", _old_kernel(s), tile)
                                        for s in (1.0 + 1e-7, 1.0 - 1e-7)]]
    k8 = power.blockjac_dev_dots
    try:
        for storage, (name, launch, rule), switches, apply in cases:
            fused_ho._launch, fused_ho.ho_tile = launch, rule
            power.blockjac_dev_dots = k8 if apply == "K8" else _bmm_route()
            s = runs[storage].solver
            s.set_tol(*bench.HO_TOL)
            s.reset_flux()
            with bench.env(**switches):
                k = s.SolveKeff()
            print(json.dumps({"blocks": storage, "switches": switches, "block_apply": apply,
                              "k6": name, "keff": round(k, 7), "outers": s._last_outers,
                              "inners": s._last_inners, **_tail(s, bench.HO_TOL[1]),
                              "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        fused_ho._launch, fused_ho.ho_tile = tiled, tile
        power.blockjac_dev_dots = k8


def perturbed_start(s, rel: float, seed: int):
    """Set solver ``s``'s start flux to the flat flux times 1 + ``rel`` x a
    seeded normal sample (drawn in float64 on the solver's device, cast to
    its dtype): ``rel`` 1e-7 moves float32 entries by about one ulp."""
    flat = s._flat_phi()
    g = torch.Generator(device=flat.device).manual_seed(seed)
    noise = torch.randn(flat.shape, generator=g, device=flat.device, dtype=torch.float64)
    s._phi = flat * (1 + rel * noise.to(flat.dtype))


def accel_probe(device="cuda") -> None:
    """Every row of ``bench.ACCEL_CONFIGS`` x ``bench.ACCELS`` at float32 from
    the flat flux and from four start fluxes perturbed by one float32 ulp
    (seeds 1-4), and at float64 from the flat flux and two 1e-15
    perturbations (seeds 1-2); one JSON line a row and dtype with each
    solve's (k, outers, inners)."""
    device = torch.device(device)
    data = bench.load_benchmark_data()
    for dtype, rel, seeds in ((torch.float32, 1e-7, (1, 2, 3, 4)),
                              (torch.float64, 1e-15, (1, 2))):
        for core, kw, tol in bench.ACCEL_CONFIGS:
            s = bench.BenchmarkRun(data.BENCHMARKS[core], device=device, dtype=dtype,
                                   **kw).solver
            s.set_tol(*tol)
            for accel in bench.ACCELS:
                s.set_acceleration(accel)
                out = []
                for seed in (None, *seeds):
                    s.reset_flux()
                    if seed is not None:
                        perturbed_start(s, rel, seed)
                    out.append((round(s.SolveKeff(), 8), s._last_outers, s._last_inners))
                print(json.dumps({"core": core, "accel": accel, "dtype": str(dtype),
                                  "perturbation": rel, "flat_then_seeds": out,
                                  "device": bench.card_line(device)}), flush=True)
            del s


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="counts under rounding, on the GPU")
    ap.add_argument("--accel", action="store_true",
                    help="the accelerator matrix's rows (accel_probe)")
    if ap.parse_args().accel:
        accel_probe()
    else:
        main()
