"""Smoke test of the PyTorch port (neutfem_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result prints):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on its path's
   operands, with times and bounds: K1-K3 on IAEA-3D 6x6x4 RT0-P0
   (76x114x114 cells, group 0), K1 also at the 8x8x8 line path's z lines
   (152^3, random operands), K4 at the three compute_current layouts of
   6x6x4 and at the line preconditioner's z solve (1, 152, 152, 152), K5
   and K1's group batch on the 6x6x4 operands with both groups at once (2,
   1, 76, 114, 114) and on a ragged 3-group grid, K6 on IAEA-3D 4x4x2 RT2-P2 (K1 = 3) and RT1-P1 (K1 = 2) (38x76x76
   cells), the fused y and x directions (K2, K3) on ZION 48x48 (912x912
   cells, 912 lines per direction: few, long lines) and KOEBERG 32x32
   (544x544), K4′ at compute_current's 2D y layouts of ZION (2, 1, 1, 913,
   912) and KOEBERG (4, 1, 1, 545, 544) and at ZION's 2D line
   preconditioner (1, 1, 912, 912); the five equilibration-folded directions (K7) on
   the 6x6x4 operands; the fused block-Jacobi apply + dots (K8) on the 4x4x2
   RT2-P2 and RT1-P1 blocks in the fp8 E-form the context holds and in
   bfloat16, and the kernels' e4m3 widening of all 254 finite bytes against
   torch's; float32.  K2 and K3 are the tiled kernel of csrc/fused_rows.cu,
   K5 its group-batched form; K1 and its batch the face-major tiled kernels
   of csrc/fused_z_rows.cu; K4 the tiled kernel of csrc/thomas_rows.cu; K6
   the tiled kernel of csrc/fused_ho_rows.cu, K7 that of
   csrc/fused_eq_rows.cu; K8 that of csrc/blockjac_tiled.cu; K4′ that of
   csrc/thomas_wide_rows.cu; at each of their shapes the kernel they
   replaced (csrc/fused_dir.cu, csrc/thomas.cu's thread-per-line and
   thomas_wide_kernel, csrc/fused_ho.cu, csrc/fused_eq.cu, csrc/blockjac.cu
   on the bf16 inverse) runs beside it on the same
   operands, both held to the plain version and timed in turns (its time is
   the row's ``old_ms``), and the tiled kernel is swept over the tiles of
   ``Z_SWEEP`` (z lines: K1, its batch, K7's z variants, and every K4
   layout; for K1 also K2's kernel at the z strides), ``ROWS_SWEEP`` (K2,
   K3, K5, K7's x and y variants), ``HO_SWEEP`` (K6), ``_k8_tiles`` (K8) or
   ``WIDE_SWEEP`` (K4′);
4. reference: the IAEA-3D 1x1 solves at float64 — RT0-P0 and RT1-P1, the
   Jacobi group sweep, the free-running adjoint, and RT0-P0 under
   ``NEUTFEM_EQFOLD=1`` and ``=2`` (K7) — and the KOEBERG 4x4 2D solve
   (68x68 cells, with the tiled K2 / K3 kernel launched) on the GPU agree
   with the same solves through the plain versions on the CPU; the RT1-P1
   solve launches the tiled K6 in every direction, the Jacobi sweep the
   batched tiled K5 in y and x, each compute_current the tiled K4;
5. RT0 main path: ``neutfem_tpu_torch.bench.main(6, 4)`` (float32), checked
   against the parity anchors of the JAX package's benchmark (k 1.029104,
   34 outers, 1068 inners), with every kernel's launch count > 0;
6. higher-order paths: ``bench.main_ho(1)`` and ``bench.main_ho(2)`` (IAEA-3D
   4x4x2, float32) against the JAX package's RT1-P1 / RT2-P2 anchors, with
   the tiled K6 (every direction) and the tiled K4 launched in each, K8 on
   the fp8 E-form at least once per CG iteration, and the
   thread-per-(mode, line) K6, the inverse-form and thread-per-cell K8 and
   the thread-per-line K4 not at all;
7. 2D paths: ``bench.main_2d("koeberg2d", 32)`` and ``main_2d("zion2d", 48)``
   (float32) against the JAX package's anchors, with the two-grid coarse
   level attached (the group solves resolve "auto" to "twogrid"), the tiled
   y and x kernels and the tiled K4′ launched in each and the thread-per-line
   y and x kernel and the first K4′ kernel not at all;
8. line path: ``bench.main_scale()`` (IAEA-3D 8x8x8, 3.5M cells, float32)
   against its anchor (k within 2e-5, ``SCALE_KEFF_TOL``), with the line
   preconditioner: at least one tiled z Thomas launch (K4) per CG
   iteration, and none of the thread-per-line K4;
9. Jacobi path: ``bench.main_sweep("jacobi")`` (IAEA-3D 6x6x4, float32, every
   group in one batched CG): the batched kernels (the tiled K5, K1's batch)
   launched, the thread-per-line batched y / x and the one-group K1-K3
   (either kernel) not, converged below 600 outers, k within 2e-5
   (``SWEEP_KEFF_TOL``) of the Gauss-Seidel solve at the same tolerances and
   of phase [5]'s k;
10. adjoint path: ``bench.main_adjoint()`` (``bench.py --full``'s IAEA-3D
   6x6x4 free-running adjoint row) against its float32 anchors;
11. facade variants on IAEA-3D 6x6x4 (float32, at ``bench.SWEEP_TOL``):
   ``SolveKeff(use_cmfd=True)`` and ``SolveKeff(use_coarse_init=True,
   coarse_factors=(3, 3, 4))`` within 3e-5 of the Chebyshev k, and
   DIRECT_LLT on IAEA-2D 3x3 (3,249 flux DOFs, under the 4096 gate) within
   1e-5 of its CG k;
12. opt-in paths, each under its switches (set and restored around the run):
   ``bench.main(6, 4)`` under ``NEUTFEM_EQFOLD=1`` and ``=2`` at phase [5]'s
   anchors, with the tiled eq kernels (K7) launched at least once per CG
   iteration and the one-group x and z kernels (and y in mode 2; either
   kernel) and the thread-per-line K7 not at all;
   ``bench.main_ho(1)`` under ``NEUTFEM_BLKFP8=0 NEUTFEM_BLOCKJAC=1`` with
   bfloat16 block storage, the tiled K8 on the inverse launched at least
   once per CG iteration (the thread-per-cell one and the E-form not), the
   tiled K6 in every direction and the old K6 not at all, at the
   RT1-P1 anchors (inners against the JAX package's float32
   ``NEUTFEM_BLKFP8=0`` count); ``bench.main(6, 4)`` under ``NEUTFEM_CGCG=1``
   at phase [5]'s anchors;
13. CG graphs: one cold group solve each through the plan's captured graph
   against the eager block loop (the same bits, counts and launches);
14. the facade's surface, each part with its own counts: (a) the accelerator
   matrix ``bench.main_accel()`` (IAEA-2D and KOEBERG 8x8, IAEA-3D 6x6x4;
   none, chebyshev and anderson) on ``ACCEL_ANCHORS``, K1-K4 launched in the
   Anderson 6x6x4 solve; (b) the quarter core (IAEA-3D 6x6x4 ``quart_so``,
   57x57x76 cells) and the half core (IAEA-2D 8x8 ``moitie_s``) within 2e-5
   of their full cores' k; (c) the subcritical solve of IAEA-3D 6x6x4 with
   nu-Sigma_f x 0.9 and a fast source in the fuel (``SolveKeff``,
   ``reset_flux``, ``SolveSubcritical``): M finite and > 1, within 1e-3 of
   the float64 M on the card, K1-K4 launched; (d) ``zoom_resolved([2, 2,
   2])`` of IAEA-3D 3x3x2 onto 114x114x76 cells, K1-K4 launched, near
   ``project_flux`` (``tests/test_compat_api.py``'s bounds); (e) a
   checkpoint of a 6x6x4 solve loaded into a fresh facade (the warm solve at
   the saved k in fewer outers) and ``ExportVTK``'s fields; (f) IAEA-3D 1x1
   at float64, the card against the CPU: the Anderson solve (|dk| <= 1e-9,
   the same outers), M and the zoomed flux (rel 1e-9).

Every kernel row's bound is the larger of its bytes (each input read once,
each output written once, from the tensors of this run) over 3.35 TB/s and
its floating-point operations over 67 TFLOP/s (the H100 SXM's float32 rate
outside the tensor cores).  No single PyTorch call computes the functions of
K1-K7, so their rows' ``library_ms`` is null; K8's is the port's former
default block apply on the same stored blocks (``torch.bmm`` on their
float32 copy, then the two dots as ``torch.sum``), timed here and used by
no K8 path.  The old / new comparisons (K1-K8) time each kernel behind a queued
sleep, so that the host enqueues every launch before the card starts them:
their rows measure device time, not the wrapper's host cost (the tiled
kernel takes ~10 µs); they carry ``old_ms``, ``tile`` and ``share_of_bound``.

Launch counts are set to 0 just before each path and read just after it.
The last two lines are a JSON object of per-kernel results and the contract
line ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

KEFF_ANCHOR, KEFF_TOL = 1.029104, 1e-5
OUTERS_ANCHOR, OUTERS_TOL = 34, 3
INNERS_ANCHOR, INNERS_REL = 1068, 0.15
KERNEL_REL_TOL = 1e-5  # float32, FMA contraction in the kernels vs the plain recurrence
# IAEA-3D 4x4x2 RT_k-P_k float32 anchors of the JAX package (BENCH_extra.json):
# order -> (k, outers, inners)
HO_ANCHORS = {1: (1.0292783, 49, 1151), 2: (1.0292925, 50, 2101)}
# RT1-P1 4x4x2 under NEUTFEM_BLKFP8=0 (bfloat16 blocks), the JAX package at
# float32 on a CPU: k 1.0292788, 49 outers, 1149 inners, from
#   NEUTFEM_X64=0 NEUTFEM_BLKFP8=0 JAX_PLATFORMS=cpu python -c "from benchmarks.runner
#   import BenchmarkRun; from benchmarks.data import BENCHMARKS; r = BenchmarkRun(
#   BENCHMARKS['iaea3d'], mesh_n=4, mesh_nz=2, rt_order=1); print(r.solve(tol=(1e-7,
#   1e-5, 1e-5, 120, 1000)), r.solver._last_outers, r.solver._last_inners)"
# k and outers are held to the RT1-P1 anchor above, inners to this count
BLOCKJAC_INNERS = 1149
# the K7 wrappers: key -> (direction d, TPU kernel); d 0 = x, 1 = y, 2 = z
EQ_REPLACES = {"x_eq": (0, "neutfem_tpu/ops/pallas_fused.py:574"),
               "z_eq": (2, "neutfem_tpu/ops/pallas_fused.py:602"),
               "x_eq2": (0, "neutfem_tpu/ops/pallas_fused.py:625"),
               "y_eq2": (1, "neutfem_tpu/ops/pallas_fused.py:652"),
               "z_eq2": (2, "neutfem_tpu/ops/pallas_fused.py:681")}
# the tiled K7 launches each fold mode's path must show, and the kernels it
# must not launch: the one-group x and z directions (and y in mode 2; either
# kernel) and the thread-per-line K7 (every key)
EQ_OLD = tuple(EQ_REPLACES)
EQ_MODES = {"1": (("x_eq_rows", "z_eq_rows"), ("x", "x_rows", "z", "z_rows", *EQ_OLD)),
            "2": (("x_eq2_rows", "y_eq2_rows", "z_eq2_rows"),
                  ("x", "x_rows", "y", "y_rows", "z", "z_rows", *EQ_OLD))}
# the tiles (lines per block, chunks per line) [3] sweeps the tiled K2 / K3
# kernel over, beside the one fused.rows_tile picks
ROWS_SWEEP = ((2, 32), (4, 32), (8, 32), (16, 32), (8, 16), (16, 16))
ROWS_REPLACES = {"z": "neutfem_tpu/ops/pallas_fused.py:466",
                 "y": "neutfem_tpu/ops/pallas_fused.py:518",
                 "x": "neutfem_tpu/ops/pallas_fused.py:547"}
# the tiles [3] sweeps the tiled kernels over on z lines (K1, its batch, K2's
# kernel at the z strides beside them, and the z variants of K7): every
# lines x chunks of {8, 16, 32, 64} x {2, 4, 8, 16, 32} (a tile under one
# warp or over 1024 threads is refused)
Z_SWEEP = tuple((tl, ch) for tl in (8, 16, 32, 64) for ch in (2, 4, 8, 16, 32))
# the tiles (lines per block, chunks per line) [3] sweeps the tiled K4′ over
# (at most 256 threads a block and 32 lines; others are refused)
WIDE_SWEEP = ((8, 32), (4, 32), (16, 16), (8, 16), (4, 64), (2, 64), (2, 128), (1, 256))
# (inner, outer_stride, cell_stride) of one group's lines along a direction,
# from the grid (nz, ny, nx): the wrappers' strides (ops/fused.py)
STRIDES = {"z": lambda nz, ny, nx: (ny * nx, 0, ny * nx),
           "y": lambda nz, ny, nx: (nx, ny * nx, nx),
           "x": lambda nz, ny, nx: (1, nx, 1)}
# the tiles (lines per block, chunks per (transverse mode, line)) [3] sweeps
# the tiled K6 kernel over, each with one transverse mode per block and with
# K1 of them
HO_SWEEP = ((8, 8), (16, 4), (16, 8), (32, 4), (32, 8))
# launch keys of the tiled K6 and K5 kernels, and of the kernels they
# replaced (held at 0 on every path)
HO_KEYS, HO_OLD = ("ho_z_rows", "ho_y_rows", "ho_x_rows"), ("ho_z", "ho_y", "ho_x")
K5_KEYS, K5_OLD = ("y_batched_rows", "x_batched_rows"), ("y_batched", "x_batched")
# the one-group tiled K1-K3 and the thread-per-line kernels they replaced
Z_KEYS, Z_OLD = ("z_rows", "y_rows", "x_rows"), ("z", "y", "x")
K4_REPLACES = {"z": "neutfem_tpu/ops/pallas_tridiag.py:181",
               "y": "neutfem_tpu/ops/pallas_tridiag.py:213",
               "x": "neutfem_tpu/ops/pallas_tridiag.py:229"}
HO_REPLACES = {"z": "neutfem_tpu/ops/pallas_fused_ho.py:460",
               "y": "neutfem_tpu/ops/pallas_fused_ho.py:389",
               "x": "neutfem_tpu/ops/pallas_fused_ho.py:425"}
# float32 anchors of the JAX package (BENCH_extra.json): (k, outers, inners)
ANCHORS_2D = {"koeberg2d": (1.0079671, 34, 3836), "zion2d": (1.274965, 30, 4391)}
MESH_2D = {"koeberg2d": 32, "zion2d": 48}
SCALE_ANCHOR = (1.0291848, 34, 1341)  # IAEA-3D 8x8x8, "auto" -> line
# k tolerance of the 8x8x8 row: at this tolerance set a float32 solve's k
# lands 1e-5 to 4e-5 from the float64 k, and two float32 implementations
# land up to ~1e-5 apart.  Measured: on an H100 this port gives 1.0291923 at
# float64 and 1.0291735 at float32, 1.13e-5 below the JAX package's float32
# anchor; at IAEA-3D 2x2x2 on a CPU the two packages agree at float64 to
# 1e-15, while their float32 solves sit 3.2e-5 and 3.7e-5 above it.  Summing
# the reductions in float64 does not move the float32 k.  1e-5 would test
# float32 rounding, not the port.
SCALE_KEFF_TOL = 2e-5
# Jacobi sweep vs Gauss-Seidel at bench.SWEEP_TOL: the same fixed point, up to
# the float32 rounding band of these tolerances (above) and the sweep's slower
# convergence (IAEA-3D 1x1 and 2x2x2 float64 on a CPU: 5e-6 to 8e-6 apart).
SWEEP_KEFF_TOL = 2e-5
# bench.py --full's IAEA-3D 6x6x4 free-running adjoint row, float32
# (BENCH_extra.json): k-adjoint, k-direct, outers
ADJOINT_ANCHOR = (1.0291064, 1.0291045, 37)
ADJ_KEFF_TOL = 1e-5
# CMFD and coarse init against the Chebyshev k: each stops at |dk| < tol_keff
# from its own side of the fixed point (benchmarks/accel_compare.py allows 3x)
VARIANT_KEFF_TOL = 3e-5
DIRECT_KEFF_TOL = 1e-5
# [14] the accelerator matrix (bench.main_accel), anchors of the JAX
# package: (core, accel) -> (k, outers, inners).  IAEA-3D 6x6x4 from
# ACCEL_r04.json (float32); the 2D rows measured with the JAX package on a
# CPU at float32 (benchmarks.accel_compare.run_matrix, NEUTFEM_X64=0), but
# IAEA-2D anderson at float64: at float32 the JAX package on a CPU gives 35 /
# 1093 (35-37 outers from start fluxes perturbed by one float32 ulp), a
# rounding basin that neither ACCEL_r04.json (52 / 1343) nor the port (50-51)
# reaches; at float64 both packages give 50 / 1308
ACCEL_ANCHORS = {
    ("iaea2d", "none"): (1.0295749, 179, 5795),
    ("iaea2d", "chebyshev"): (1.0295758, 49, 1937),
    ("iaea2d", "anderson"): (1.0295755, 50, 1308),
    ("koeberg2d", "none"): (1.0080199, 149, 5201),
    ("koeberg2d", "chebyshev"): (1.0080212, 49, 2328),
    ("koeberg2d", "anderson"): (1.0080205, 48, 1489),
    ("iaea3d", "none"): (1.0290917, 172, 3704),
    ("iaea3d", "chebyshev"): (1.0291045, 34, 1068),
    ("iaea3d", "anderson"): (1.0291111, 80, 1322),
}
# a row whose count from a flat flux misses its anchor is solved again from
# start fluxes perturbed by one float32 ulp (relative 1e-7, seeds 1-4): its
# outer count moves with rounding (on an H100: KOEBERG chebyshev 36 outers
# from the flat flux, 49 from every perturbed one; IAEA-3D anderson 59, then
# 82-88, and 84-89 at float64 under 1e-15), and one of those solves must
# land on the anchor, every k within KEFF_TOL
ACCEL_PERTURB_SEEDS = (1, 2, 3, 4)
# a quarter or half core against the full core at the same tolerances
DOMAIN_KEFF_TOL = 2e-5
# the subcritical solve's M at float32 against float64, relative: the source
# iteration stops at dphi < 1e-5 (bench.SWEEP_TOL) and contracts at ~k = 0.93,
# so its error may reach ~14 times that
SUBCRIT_M_REL = 1e-3
# the H100 SXM's published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# floating-point operations per cell of one fused RT0 direction: the face
# rhs (3), the forward elimination (3), the backward sweep (3), the divergence
# update (4)
FUSED_FLOPS_PER_CELL = 13
# per element of a Thomas solve: forward 2, diagonal 1, backward 2
THOMAS_FLOPS_PER_ELEMENT = 5


def _timed(fn, reps, queued=False):
    """Mean milliseconds per call over ``reps`` calls (CUDA events, after a
    warm-up).  ``queued``: the card first sleeps ~11 ms while the host
    enqueues every call, so a call's host cost does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(tensors, flops):
    """(bound ms, "bytes" | "operations"): the least time for reading every
    input once and writing every output once (``tensors``, outputs listed as
    often as they are written) or for ``flops`` float32 operations."""
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _row(name, source, replaces, key, err, ms, plain_ms, bound, library_ms=None):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "key": key,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


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


def _check_anchor(what, keff, outers, inners, anchor, keff_tol=KEFF_TOL):
    k_a, o_a, i_a = anchor
    if not abs(keff - k_a) <= keff_tol:
        raise RuntimeError(f"{what}: keff {keff} is not within {keff_tol} of {k_a}")
    if not abs(outers - o_a) <= OUTERS_TOL:
        raise RuntimeError(f"{what}: {outers} outers, expected {o_a} +- {OUTERS_TOL}")
    if not abs(inners - i_a) <= INNERS_REL * i_a:
        raise RuntimeError(f"{what}: {inners} inners, expected {i_a} +- 15%")


def _current_operands(fes, ctx, di, phi):
    """compute_current's Thomas operands for direction ``di``: (rhs (ng, 1,
    faces...), dinv, l, axis), the factors broadcast and contiguous."""
    from neutfem_tpu_torch.ops.apply import apply_BT_dir

    key = f"d{di.d}"
    rF, _ = apply_BT_dir(fes, di, phi)
    rFs = (rF * ctx[f"mask_{key}"]) / float(di.m_t[0])
    dinv = ctx[f"tri_dinv_{key}"].unsqueeze(-4).expand(rFs.shape).contiguous()
    lsh = list(rFs.shape)
    lsh[di.axis - 3] -= 1
    lf = ctx[f"tri_l_{key}"].unsqueeze(-4).expand(lsh).contiguous()
    return rFs, dinv, lf, di.axis - 3


def _wide_case(label, r, d, l, card):
    """K4′ at one wide layout (a solve along axis -2, ``thomas.wide_rows``):
    the wrapper, which launches the tiled kernel of csrc/thomas_wide_rows.cu
    at the tile ``thomas.wide_tile`` picks, and the first K4′ kernel it
    replaced (``thomas_wide_kernel``, called through the library: no launch
    counted), each against the plain version and timed in turns queued behind
    a sleep; then the tiled kernel at the tiles of ``WIDE_SWEEP``.  Returns a
    row with ``old_ms``."""
    import torch

    from neutfem_tpu_torch.ops import cuda_lib, thomas

    n, inner = r.shape[-2], r.shape[-1]
    lines = r.numel() // n
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (r.data_ptr(), d.data_ptr(), l.data_ptr())
    out = torch.empty_like(r)

    def old():
        cuda_lib.check(lib.neutfem_thomas_wide_f32(*ptrs, out.data_ptr(), n, lines, inner,
                                                   stream), "thomas_wide_kernel")
        return out

    if not thomas.wide_rows(r.shape, -2):
        raise RuntimeError(f"K4′ {label}: {tuple(r.shape)} is not the wide layout")
    want = thomas.thomas_solve_plain(r, d, l, -2)
    before = thomas.LAUNCHES["thomas_wide_rows"]
    got = thomas.thomas_solve(r, d, l, -2)
    torch.cuda.synchronize()
    if thomas.LAUNCHES["thomas_wide_rows"] != before + 1:
        raise RuntimeError(f"K4′ {label}: the wrapper did not launch the tiled kernel")
    zero = torch.zeros_like(want)
    err = _compare(f"K4′ tiled {label}", got, want, zero)
    _compare(f"K4′ thomas_wide_kernel {label}", old().clone(), want, zero)
    ms, old_ms, t = _old_new(old, lambda: thomas.thomas_solve(r, d, l, -2))
    plain_ms = _timed(lambda: thomas.thomas_solve_plain(r, d, l, -2), 3)
    bound = _bound((r, d, l, got), THOMAS_FLOPS_PER_ELEMENT * r.numel())
    tile = thomas.wide_tile(n, lines // inner, inner,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    sweep = _tile_sweep(f"K4′ tiled {label}", WIDE_SWEEP,
                        lambda _, tile: thomas.thomas_solve(r, d, l, -2, tile), want, zero, zero)
    print(f"  K4′ {label} {tuple(r.shape)}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), thomas_wide_kernel {old_ms:.4f} ms ({t[0]:.4f}, "
          f"{t[3]:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} lines of "
          f"{n}; share of bound {bound[0] / ms:.3f}; {card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K4′ Thomas solve for few, long lines (_solve_y), {label}",
               "neutfem_tpu_torch/csrc/thomas_wide_rows.cu",
               "neutfem_tpu/ops/pallas_tridiag.py:197", "thomas_wide_rows", err, ms, plain_ms,
               bound)
    row.update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/thomas.cu (thomas_wide_kernel)",
               tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
    return row


def _thomas_rows_case(label, r, d, l, axis, replaces, card):
    """K4 at one layout: the wrapper, which launches the tiled kernel at the
    tile ``thomas.thomas_tile`` picks, and the thread-per-line kernel it
    replaced (``thomas_kernel``, called through the library: no launch
    counted), each against the plain version and timed in turns queued
    behind a sleep; then the tiled kernel at the tiles of ``Z_SWEEP``.
    Returns a row with ``old_ms``."""
    import math

    import torch

    from neutfem_tpu_torch.ops import cuda_lib, thomas

    axis %= r.ndim
    n = r.shape[axis]
    inner = math.prod(r.shape[axis + 1:])
    lines = r.numel() // n
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (r.data_ptr(), d.data_ptr(), l.data_ptr())
    out = torch.empty_like(r)

    def old():
        cuda_lib.check(lib.neutfem_thomas_f32(*ptrs, out.data_ptr(), n, lines, inner, stream),
                       "thomas (thread per line)")
        return out

    want = thomas.thomas_solve_plain(r, d, l, axis)
    before = thomas.LAUNCHES["thomas_rows"]
    got = thomas.thomas_solve(r, d, l, axis)
    torch.cuda.synchronize()
    if thomas.LAUNCHES["thomas_rows"] != before + 1:
        raise RuntimeError(f"K4 {label}: the wrapper did not launch the tiled kernel")
    zero = torch.zeros_like(want)
    err = _compare(f"K4 tiled {label}", got, want, zero)
    _compare(f"K4 thread-per-line {label}", old().clone(), want, zero)
    ms, old_ms, t = _old_new(old, lambda: thomas.thomas_solve(r, d, l, axis))
    plain_ms = _timed(lambda: thomas.thomas_solve_plain(r, d, l, axis), 3)
    bound = _bound((r, d, l, got), THOMAS_FLOPS_PER_ELEMENT * r.numel())
    tile = thomas.thomas_tile(n, r.dtype, inner == 1)
    sweep = _tile_sweep(f"K4 tiled {label}", Z_SWEEP,
                        lambda _, tile: thomas.thomas_solve(r, d, l, axis, tile), want, zero, zero)
    print(f"  K4 {label} {tuple(r.shape)} axis {axis - r.ndim}: tiled kernel (tile "
          f"{tile[0]}x{tile[1]}) {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), thread-per-line "
          f"{old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({lines} lines of {n}; {card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K4 batched Thomas solve, {label}", "neutfem_tpu_torch/csrc/thomas_rows.cu",
               replaces, "thomas_rows", err, ms, plain_ms, bound)
    row.update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/thomas.cu (thomas_kernel)",
               tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
    return row


def _old_new(old, new, reps=50):
    """Device ms of ``new`` and of ``old`` on the same operands, timed in turns
    (old, new, new, old), each queued behind a sleep: (ms, old_ms, readings)."""
    t = [_timed(fn, reps, queued=True) for fn in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def _tile_sweep(name, tiles, run, want, acc0, scratch, base=None):
    """``run(acc, tile)`` at each tile, held to ``want`` (relative to the
    contribution over ``base``, default ``acc0``) and timed (queued): "lines
    x chunks ms" each, or "refused" where the card does not take the tile
    (its shared memory, or a block under one warp or over 1024 threads)."""
    out = []
    for tile in tiles:
        label = "x".join(map(str, tile))
        try:
            _compare(f"{name} tile {tile}", run(acc0.clone(), tile), want,
                     acc0 if base is None else base)
        except RuntimeError as e:
            if "CUDA launch failed" not in str(e):
                raise
            out.append(f"{label} refused")
            continue
        out.append(f"{label} {_timed(lambda: run(scratch, tile), 50, queued=True):.4f}")
    return out


def _rows_case(kid, key, ctxg, di, v, acc0, card, label):
    """K1 (z), K2 (y) or K3 (x) on one group's flux: the wrapper, which
    launches the tiled kernel at the tile ``fused.z_tile`` (z) or
    ``fused.rows_tile`` picks, and the thread-per-line kernel it replaced,
    called through the library (no launch counted), each against the plain
    version on the NATURAL operands and timed in turns (old, new, new, old);
    then the tiled kernel at the tiles of ``Z_SWEEP`` (z) or ``ROWS_SWEEP``.
    Returns a row with ``old_ms``."""
    import torch

    from neutfem_tpu_torch.ops import cuda_lib, fused

    wrapper, tag, axis = {"z": (fused.fused_schur_z, "", -3),
                          "y": (fused.fused_schur_y_pre, "yT_", -2),
                          "x": (fused.fused_schur_x_pre, "xT_", -1)}[key]
    d = f"d{di.d}"
    dm, ll = ctxg[f"tri_{tag}dinvm_{d}"], ctxg[f"tri_{tag}l_{d}"]
    nat = (ctxg[f"tri_dinvm_{d}"], ctxg[f"tri_l_{d}"])
    c = (float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]))
    nz, ny, nx = v.shape[-3:]
    n = v.shape[axis]
    lines = v.numel() // n
    strides = STRIDES[key](nz, ny, nx)
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    zs = torch.empty((n, lines), dtype=v.dtype, device=v.device)

    def old(acc):
        cuda_lib.check(lib.neutfem_fused_dir_f32(
            acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr(), zs.data_ptr(), n, lines,
            *strides, *c, stream), "fused_dir")
        return acc

    def tiled(acc, tile):
        ptrs = (acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr())
        if key == "z":
            err = lib.neutfem_fused_z_rows_f32(*ptrs, n, lines, 0, *tile, *c, stream)
        else:
            err = lib.neutfem_fused_rows_f32(*ptrs, n, lines, *strides, int(strides[2] == 1),
                                             *tile, *c, stream)
        cuda_lib.check(err, "fused_rows")
        return acc

    def rows_form(acc, tile):  # K2's kernel (rows_tile) at the z strides
        cuda_lib.check(lib.neutfem_fused_rows_f32(
            acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr(), n, lines, *strides, 0,
            *tile, *c, stream), "fused_rows")
        return acc

    want = fused.fused_dir_plain(acc0, v, *nat, axis, *c)
    before = dict(fused.LAUNCHES)
    got = wrapper(acc0.clone(), v, dm, ll, *c)
    torch.cuda.synchronize()
    if fused.LAUNCHES[f"{key}_rows"] != before[f"{key}_rows"] + 1:
        raise RuntimeError(f"{kid} {label}: the wrapper did not launch the tiled kernel")
    err = _compare(f"{kid} tiled {key} {label}", got, want, acc0)
    _compare(f"{kid} thread-per-line {key} {label}", old(acc0.clone()), want, acc0)
    scratch = acc0.clone()
    ms, old_ms, t = _old_new(lambda: old(scratch), lambda: wrapper(scratch, v, dm, ll, *c))
    plain_ms = _timed(lambda: fused.fused_dir_plain(acc0, v, *nat, axis, *c), 3)
    bound = _bound((v, acc0, got, dm, ll), FUSED_FLOPS_PER_CELL * v.numel())
    tile = (fused.z_tile if key == "z" else fused.rows_tile)(lines, n, v.dtype)
    sweep = _tile_sweep(f"{kid} tiled {key} {label}", Z_SWEEP if key == "z" else ROWS_SWEEP,
                        tiled, want, acc0, scratch)
    print(f"  {kid} {key} {label}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), thread-per-line {old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
          f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} lines of {n} cells; "
          f"{card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    source = "fused_z_rows.cu" if key == "z" else "fused_rows.cu"
    row = _row(f"{kid} fused Schur direction {key}{label}", f"neutfem_tpu_torch/csrc/{source}",
               ROWS_REPLACES[key], f"{key}_rows", err, ms, plain_ms, bound)
    row.update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/fused_dir.cu",
               tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
    if key == "z":
        row["rows_form_sweep"] = _rows_form_sweep(f"{kid} {key} {label}", rows_form, want, acc0,
                                                  scratch)
    return row


def _rows_form_sweep(name, rows_form, want, acc0, scratch):
    """K1's alternative: K2's tiled kernel (rows_tile, line-major shared rows)
    at the z strides, over ``Z_SWEEP``; the face-major z kernel is held to
    it (``rows_form_sweep`` in the K1 rows)."""
    sweep = _tile_sweep(f"{name} (rows form)", Z_SWEEP, rows_form, want, acc0, scratch)
    print(f"    rows form (fused_rows.cu at the z strides), tiles: {'; '.join(sweep)}")
    return sweep


def _batched_case(kid, key, ctx, di, v, acc0, card, label, replaces, timed=True):
    """One group-batched fused RT0 direction (K5 for y and x, K1's batch for
    z: the batched tiled kernels) on the per-group staged operands of the
    whole context, against the plain version on the natural ones.  The
    thread-per-line batched kernel it replaced (csrc/fused_dir.cu, called
    through the library: no launch counted) is held to the plain version
    too; ``timed``: both timed in turns, and the tiled kernel swept over
    ``Z_SWEEP`` (z) or ``ROWS_SWEEP``.  Returns a row."""
    import math

    import torch

    from neutfem_tpu_torch.ops import cuda_lib, fused

    wrapper, tag, axis = {"z": (fused.fused_schur_z_batched, "", -3),
                          "y": (fused.fused_schur_y_batched, "yT_", -2),
                          "x": (fused.fused_schur_x_batched, "xT_", -1)}[key]
    d = f"d{di.d}"
    dm, ll = ctx[f"tri_{tag}dinvm_{d}"], ctx[f"tri_{tag}l_{d}"]
    nat = (ctx[f"tri_dinvm_{d}"].unsqueeze(1), ctx[f"tri_l_{d}"].unsqueeze(1))
    c = (float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]))
    ng = v.shape[0]
    nz, ny, nx = v.shape[-3:]
    n = v.shape[axis]
    lines = v.numel() // n // ng
    got = wrapper(acc0.clone(), v, dm, ll, *c)
    want = fused.fused_dir_plain(acc0, v, *nat, axis, *c)
    torch.cuda.synchronize()
    err = _compare(f"{kid} {key} {label}", got, want, acc0)
    scratch = acc0.clone()
    bound = _bound((v, acc0, got, dm, ll), FUSED_FLOPS_PER_CELL * v.numel())
    new_key = f"{key}_batched_rows"
    sweep = None
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    strides = STRIDES[key](nz, ny, nx)
    gs = math.prod(v.shape[-3:])
    zs = torch.empty((ng, n, lines), dtype=v.dtype, device=v.device)

    def old(acc):
        cuda_lib.check(lib.neutfem_fused_dir_batched_f32(
            acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr(), zs.data_ptr(), n,
            lines, ng, *strides, gs, *c, stream), "fused_dir_batched")
        return acc

    def tiled(acc, tile, rows=key != "z"):
        ptrs = (acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr())
        if rows:
            err = lib.neutfem_fused_rows_batched_f32(*ptrs, n, lines, ng, *strides, gs,
                                                     int(strides[2] == 1), *tile, *c, stream)
        else:
            err = lib.neutfem_fused_z_rows_f32(*ptrs, n, lines, ng, *tile, *c, stream)
        cuda_lib.check(err, "fused_rows_batched")
        return acc

    _compare(f"{kid} thread-per-line {key} {label}", old(acc0.clone()), want, acc0)
    tile = (fused.z_tile if key == "z" else fused.rows_tile)(lines, n, v.dtype)
    extra = {"tile": list(tile), "old_source": "neutfem_tpu_torch/csrc/fused_dir.cu"}
    if timed:
        ms, old_ms, t = _old_new(lambda: old(scratch), lambda: wrapper(scratch, v, dm, ll, *c))
        sweep = _tile_sweep(f"{kid} {key} {label}", Z_SWEEP if key == "z" else ROWS_SWEEP,
                            tiled, want, acc0, scratch)
        extra.update(old_ms=old_ms, share_of_bound=bound[0] / ms, sweep=sweep)
        if key == "z":
            extra["rows_form_sweep"] = _rows_form_sweep(
                f"{kid} {key} {label}", lambda a, tile: tiled(a, tile, True), want, acc0, scratch)
    else:
        ms = _timed(lambda: wrapper(scratch, v, dm, ll, *c), 3)
    plain_ms = _timed(lambda: fused.fused_dir_plain(acc0, v, *nat, axis, *c), 3)
    old_txt = (f", thread-per-line {extra['old_ms']:.4f} ms ({t[0]:.4f}, {t[3]:.4f})"
               if "old_ms" in extra else "")
    print(f"  {kid} {key} {label} {tuple(v.shape)}: kernel {ms:.4f} ms{old_txt}  plain "
          f"{plain_ms:.4f} ms  bound {bound[0]:.4f} ms ({lines} lines of {n} cells per group; "
          f"{card})")
    if sweep:
        print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    source = "fused_z_rows.cu" if key == "z" else "fused_rows.cu"
    row = _row(f"{kid} fused Schur direction {key}, group-batched (_fused_{key} on (ng, 1, ...))",
               f"neutfem_tpu_torch/csrc/{source}", replaces, new_key, err, ms, plain_ms, bound)
    row.update(extra)
    return row


def _eq_case(key, ctxg, di, y, acc0, sdi, ce, card):
    """One K7 wrapper on the 6x6x4 direction operands (group 0): the wrapper,
    which launches the tiled kernel at the tile ``fused_eq.eq_tile`` picks,
    and the thread-per-line kernel it replaced (csrc/fused_eq.cu, called
    through the library: no launch counted), each on the staged operands
    against ``fused_eq_plain`` on the natural ones and timed in turns; then
    the tiled kernel at the tiles of ``Z_SWEEP`` (z) or ``ROWS_SWEEP``.
    Returns a row with ``old_ms``."""
    import torch

    from neutfem_tpu_torch.ops import cuda_lib, fused_eq

    d, replaces = EQ_REPLACES[key]
    axis, tag = {0: (-1, "tri_xT_"), 1: (-2, "tri_yT_"), 2: (-3, "tri_")}[d]
    dkey = "xyz"[d]
    dm, ll = ctxg[f"{tag}dinvm_d{d}"], ctxg[f"{tag}l_d{d}"]
    nat = (ctxg[f"tri_dinvm_d{d}"], ctxg[f"tri_l_d{d}"])
    c = (float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]))
    wrapper = getattr(fused_eq, f"fused_schur_{key}")
    flags = fused_eq._FLAGS[key]
    n = y.shape[axis]
    lines = y.numel() // n
    strides = STRIDES[dkey](*y.shape[-3:])
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    zs = torch.empty((n, lines), dtype=y.dtype, device=y.device)
    u_buf = torch.empty_like(y)
    ce_ptr = ce.data_ptr() if key.startswith("x") else None

    def call(acc):
        if key.startswith("x"):
            return wrapper(y, sdi, ce, dm, ll, *c)
        if key == "z_eq":
            return wrapper(acc, y, dm, ll, sdi, *c)
        return wrapper(acc, y, sdi, dm, ll, *c)

    def raw(fn, acc, *tile):
        """the old (no tile) or the tiled kernel through the library: the
        output (a new tensor for the x variants, as the wrapper)"""
        out = torch.empty_like(y) if key.startswith("x") else acc
        pre = (zs.data_ptr(),) if not tile else ()
        cuda_lib.check(fn(flags, out.data_ptr(), y.data_ptr(), sdi.data_ptr(), ce_ptr,
                          dm.data_ptr(), ll.data_ptr(), *pre, u_buf.data_ptr(), n, lines,
                          *strides, *tile, *c, stream), key)
        return out

    def old(acc):
        return raw(lib.neutfem_fused_eq_f32, acc)

    def tiled(acc, tile):
        return raw(lib.neutfem_fused_eq_rows_f32, acc, *tile)

    before = dict(fused_eq.LAUNCHES)
    got = call(acc0.clone())
    got, got_u = got if key == "x_eq" else (got, None)
    if fused_eq.LAUNCHES[f"{key}_rows"] != before[f"{key}_rows"] + 1:
        raise RuntimeError(f"K7 {key}: the wrapper did not launch the tiled kernel")
    want, want_u = fused_eq.fused_eq_plain(key, acc0, y, sdi, ce, *nat, axis, *c)
    torch.cuda.synchronize()
    base = ce * y if key.startswith("x") else (sdi * acc0 if key.startswith("z") else acc0)
    err = _compare(f"K7 tiled {key}", got, want, base)
    if got_u is not None and not torch.equal(got_u, want_u):
        raise RuntimeError("K7 x_eq: u differs from sdi*y")
    _compare(f"K7 thread-per-line {key}", old(acc0.clone()), want, base)
    if key == "x_eq" and not torch.equal(u_buf, want_u):
        raise RuntimeError("K7 x_eq (thread-per-line): u differs from sdi*y")
    scratch = acc0.clone()
    ms, old_ms, t = _old_new(lambda: old(scratch), lambda: call(scratch))
    plain_ms = _timed(lambda: fused_eq.fused_eq_plain(key, acc0, y, sdi, ce, *nat, axis, *c), 3)
    reads = [y, sdi, dm, ll] + ([ce] if key.startswith("x") else [acc0])
    writes = [got] + ([got_u] if got_u is not None else [])
    # per cell: the fused direction, plus u = sdi*y (1), ce*y + (2), sdi*( ) (1)
    extra = {"x_eq": 3, "z_eq": 1, "x_eq2": 3, "y_eq2": 1, "z_eq2": 2}[key]
    bound = _bound(reads + writes, (FUSED_FLOPS_PER_CELL + extra) * y.numel())
    tile = fused_eq.eq_tile(axis, lines, n, y.dtype)
    sweep = _tile_sweep(f"K7 tiled {key}", Z_SWEEP if dkey == "z" else ROWS_SWEEP, tiled, want,
                        acc0, scratch, base)
    print(f"  K7 {key}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f}), thread-per-line {old_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} lines of {n} cells per launch; "
          f"{card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K7 equilibration-folded Schur direction {key} (6x6x4)",
               "neutfem_tpu_torch/csrc/fused_eq_rows.cu", replaces, f"{key}_rows", err, ms,
               plain_ms, bound)
    row.update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/fused_eq.cu", tile=list(tile),
               share_of_bound=bound[0] / ms, sweep=sweep)
    return row


def _k8_tiles(P):
    """The (wide, warps) tiles [3] sweeps the tiled K8 over: 16- and 8-byte
    plane loads, by the warp counts up to 9 that split P's rows, and 4 and 8."""
    warps = sorted({w for w in range(1, 10) if P % w == 0} | {w for w in (4, 8) if w <= P})
    return [(wide, w) for wide in (1, 0) for w in warps]


def _blockjac_case(fes, ctxg, order, card, rng):
    """K8 on one group's blocks of this order in both storage forms the paths
    use: the fp8 E-form the context holds (the default) and its bfloat16
    inverse (the layout of NEUTFEM_BLKFP8=0).  For each, the wrapper (the
    tiled kernel) and the thread-per-cell kernel it replaced, on the bf16
    inverse of the same blocks (called through the library: no launch
    counted), both held to the plain version and timed in turns queued
    behind a sleep; then the tiled kernel at the tiles of ``_k8_tiles``.
    library_ms is the port's previous default apply on the same stored
    blocks (``power._block_precond``: torch.bmm on their float32 copy) plus
    the two dots.  Returns the rows, E-form first."""
    import torch

    from neutfem_tpu_torch.ops import blockjac, cuda_lib
    from neutfem_tpu_torch.power import _block_precond

    P = fes.P
    dev = ctxg["C"].device
    eform = ctxg["precond_blk_dev"]
    eye = torch.eye(P, device=dev).reshape(P, P, 1, 1, 1)
    bi = (eform.float() + eye).bfloat16().contiguous()
    r = torch.as_tensor(rng.standard_normal((P, *fes.mesh.shape)), dtype=torch.float32,
                        device=dev)
    cells = r.numel() // P
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    part = torch.empty((lib.neutfem_blockjac_blocks(cells), 2), dtype=torch.float32, device=dev)
    z_old = torch.empty_like(r)

    def old():  # the thread-per-cell kernel on the bf16 inverse
        cuda_lib.check(lib.neutfem_blockjac_bf16(bi.data_ptr(), r.data_ptr(), z_old.data_ptr(),
                                                 part.data_ptr(), P, cells, stream),
                       "blockjac (thread per cell)")
        rz, rr = torch.sum(part, dim=0)
        return z_old, rz, rr

    def dots_agree(name, got, want):
        for what, g, w in (("<r,z>", got[1], want[1]), ("<r,r>", got[2], want[2])):
            rel = abs(float(g) - float(w)) / abs(float(w))
            print(f"  {name} {what}: {float(g):.7e} vs {float(w):.7e} (rel {rel:.2e})")
            if not rel <= KERNEL_REL_TOL:
                raise RuntimeError(f"{name}: {what} disagrees with the plain version")

    want_bf16 = blockjac.blockjac_dots_plain(bi, r)
    got_old = old()
    torch.cuda.synchronize()
    _compare(f"K8 RT{order}-P{order} thread-per-cell (bf16) z", got_old[0], want_bf16[0],
             torch.zeros_like(r))
    dots_agree(f"K8 RT{order}-P{order} thread-per-cell (bf16)", got_old, want_bf16)
    rows = []
    for form, blk, wrapper, key, deviation in (
            ("E-form", eform, blockjac.blockjac_dev_dots, "blockjac_dev", True),
            ("bf16", bi, blockjac.blockjac_dots, "blockjac_tiled", False)):
        name = f"K8 RT{order}-P{order} {form}"
        before = blockjac.LAUNCHES[key]
        got = wrapper(blk, r)
        plain = blockjac.blockjac_dots_plain(blk, r, deviation)
        torch.cuda.synchronize()
        if blockjac.LAUNCHES[key] != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch the tiled kernel")
        base = r if deviation else torch.zeros_like(r)  # z - base: the blocks' contribution
        err = _compare(f"{name} z", got[0], plain[0], base)
        dots_agree(name, got, plain)
        ms, old_ms, t = _old_new(old, lambda: wrapper(blk, r))
        sweep = _tile_sweep(name, _k8_tiles(P), lambda _, tile: wrapper(blk, r, tile)[0],
                            plain[0], r, r, base)
        plain_ms = _timed(lambda: blockjac.blockjac_dots_plain(blk, r, deviation), 3)
        apply = _block_precond({"precond_blk_dev" if deviation else "precond_blk_inv": blk},
                               torch.float32)  # the float32 copy, once

        def library():
            zl = apply(r)
            return torch.sum(r * zl), torch.sum(r * r)

        library_ms = _timed(library, 20)
        # per cell: P^2 multiply-adds, the identity (E-form), the two dots
        bound = _bound((blk, r, got[0]), cells * (2 * P * P + (P if deviation else 0) + 4 * P))
        tile = blockjac.blockjac_tile(P)
        print(f"  {name} (P={P}, {cells} cells): tiled kernel (tile {tile}) {ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), thread-per-cell on bf16 {old_ms:.4f} ms ({t[0]:.4f}, "
              f"{t[3]:.4f}), plain {plain_ms:.4f} ms, library (bmm on the float32 copy + 2 dots) "
              f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms ({card})")
        print(f"    tiles (wide x warps: ms): {'; '.join(sweep)}")
        path = "phase [6]'s RT path" if deviation else "phase [12]'s RT1-P1 BLOCKJAC path"
        row = _row(f"K8 block-Jacobi apply + dots (RT{order}-P{order} 4x4x2, {form} blocks; "
                   f"launches: {path})", "neutfem_tpu_torch/csrc/blockjac_tiled.cu",
                   "neutfem_tpu/ops/pallas_blockjac.py:114", key, err, ms, plain_ms, bound,
                   library_ms)
        row.update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/blockjac.cu (thread per "
                   "cell, on the bf16 inverse of the same blocks)", tile=list(tile),
                   share_of_bound=bound[0] / ms, sweep=sweep)
        rows.append(row)
    return rows


def _e4m3_decode_check(dev):
    """K8's e4m3 widening (cvt e4m3x2 -> f16x2 -> f32) of all 254 finite
    e4m3 bytes against torch's float8_e4m3fn -> float32: the E-form entry at
    P = 1 on r = 1 gives z = 1 + E, exact in float32 for every e4m3 value,
    so z - 1 is the widened E, equal in value (the same bits but for the
    sign of zero, which z = 1 + E cannot show)."""
    import torch

    from neutfem_tpu_torch.ops import blockjac

    finite = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F] + [0, 0],
                          dtype=torch.uint8, device=dev).view(torch.float8_e4m3fn)
    z = blockjac.blockjac_dev_dots(finite.reshape(1, 1, -1), torch.ones((1, 256), device=dev))[0]
    got, want = (z - 1.0).reshape(-1), finite.float()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"K8's e4m3 widening differs from torch's on "
                           f"{int((got != want).sum())} of 254 bytes")
    print("  K8 e4m3 widening: all 254 finite bytes equal torch's float8_e4m3fn -> float32")


def _ho_kernels(bench, order, card, rng):
    """K6 z / y / x against fused_ho_plain on the IAEA-3D 4x4x2 RT_k-P_k operands
    (group 0, float32): the wrapper, which launches the tiled kernel at the
    tile ``fused_ho.ho_tile`` picks, and the thread-per-(mode, line) kernel it
    replaced, called through the library (no launch counted), both held to
    the plain version and timed in turns; then the tiled kernel at the tiles
    of ``HO_SWEEP``.  The plain version reads the NATURAL operands and takes
    its mode grouping from the FE space's p -> t map; the kernels read the
    staged ones and compute their own mode index.  Returns the rows and K8's."""
    import torch

    from neutfem_tpu_torch.ops import cuda_lib, fused_ho
    from neutfem_tpu_torch.power import ctx_group

    spec = bench.load_benchmark_data().BENCHMARKS["iaea3d"]
    run = bench.BenchmarkRun(spec, mesh_n=4, mesh_nz=2, device="cuda", dtype=torch.float32,
                             rt_order=order)
    fes = run.solver._fes
    ctxg = ctx_group(run.solver._ctx, 0)
    shape = (1, fes.P, *fes.mesh.shape)
    dev = ctxg["C"].device
    v = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    acc0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    print(f"    RT{order}-P{order} {fes.mesh.shape} P={fes.P} (K1 = {order + 1}), "
          f"group 0, float32 ({card})")
    k1 = order + 1
    nz, ny, nx = fes.mesh.shape
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for key, wrapper, axis, tag in (("z", fused_ho.fused_ho_z, 0, None),
                                    ("y", fused_ho.fused_ho_y, 1, "hoyT"),
                                    ("x", fused_ho.fused_ho_x, 2, "hoxT")):
        di = [d for d in fes.dirs if d.axis == axis][0]
        d = f"d{di.d}"
        tabs = fused_ho.ho_tables(fes, di)
        if tag is None:
            ops = (ctxg[f"tri_dinvm_{d}"], ctxg[f"tri_l_{d}"], ctxg[f"alpha_{d}"])
        else:
            ops = tuple(ctxg[f"tri_{tag}_{n}_{d}"] for n in ("dinvm", "l", "alpha"))
        natural = (ctxg[f"tri_dinvm_{d}"], ctxg[f"tri_l_{d}"], ctxg[f"alpha_{d}"])
        n = fes.mesh.shape[axis]
        lines = nz * ny * nx // n
        # inner, outer, cell strides of the wrappers (fused_ho.py)
        strides = {0: (ny * nx, 0, ny * nx), 1: (nx, ny * nx, nx), 2: (1, nx, 1)}[axis]
        tab = torch.as_tensor(tabs.packed(), dtype=torch.float32, device=dev)
        zs = torch.empty((k1 * k1, n, lines), dtype=torch.float32, device=dev)
        ptrs = tuple(o.data_ptr() for o in ops)

        def old(acc):
            cuda_lib.check(lib.neutfem_fused_ho_f32(
                acc.data_ptr(), v.data_ptr(), *ptrs, tab.data_ptr(), zs.data_ptr(), k1,
                2 - axis, n, lines, *strides, nz * ny * nx, stream), "fused_ho")
            return acc

        def tiled(acc, tile):
            cuda_lib.check(lib.neutfem_fused_ho_rows_f32(
                acc.data_ptr(), v.data_ptr(), *ptrs, tab.data_ptr(), k1, 2 - axis, n, lines,
                *strides, nz * ny * nx, *tile, stream), "fused_ho_rows")
            return acc

        before = dict(fused_ho.LAUNCHES)
        got = wrapper(acc0.clone(), v, *ops, tabs)
        want = fused_ho.fused_ho_plain(acc0, v, *natural, axis - 3, tabs)
        torch.cuda.synchronize()
        if fused_ho.LAUNCHES[f"ho_{key}_rows"] != before[f"ho_{key}_rows"] + 1:
            raise RuntimeError(f"K6 RT{order} {key}: the wrapper did not launch the tiled kernel")
        err = _compare(f"K6 RT{order} tiled {key}", got, want, acc0)
        _compare(f"K6 RT{order} thread-per-(mode, line) {key}", old(acc0.clone()), want, acc0)
        scratch = acc0.clone()
        ms, old_ms, t = _old_new(lambda: old(scratch), lambda: wrapper(scratch, v, *ops, tabs))
        plain_ms = _timed(lambda: fused_ho.fused_ho_plain(acc0, v, *natural, axis - 3, tabs), 3)
        # per (transverse mode, cell): the face rhs over K1 longitudinal modes
        # (4 K1), the two sweeps (6), and per longitudinal mode the divergence
        # (4), the bubble block row (2 K1) and the 1/alpha scaling (1)
        flops = (v.numel() // k1) * (4 * k1 + 6 + k1 * (5 + 2 * k1))
        bound = _bound((v, acc0, got, *ops), flops)
        tile = fused_ho.ho_tile(lines, n, k1, torch.float32)
        tiles = [(tl, ch, tg) for tg in (1, k1) for tl, ch in HO_SWEEP]
        sweep = _tile_sweep(f"K6 RT{order} {key}", tiles, tiled, want, acc0, scratch)
        print(f"  K6 RT{order}-P{order} {key}: tiled kernel (tile {'x'.join(map(str, tile))}) "
              f"{ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), thread-per-(mode, line) {old_ms:.4f} ms ({t[0]:.4f}, "
              f"{t[3]:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} lines of "
              f"{n} cells; {card})")
        print(f"    tiles (lines x chunks x modes: ms): {'; '.join(sweep)}")
        rows[key] = _row(f"K6 condensed Schur direction {key} (RT{order}-P{order})",
                         "neutfem_tpu_torch/csrc/fused_ho_rows.cu", HO_REPLACES[key],
                         f"ho_{key}_rows", err, ms, plain_ms, bound)
        rows[key].update(old_ms=old_ms, old_source="neutfem_tpu_torch/csrc/fused_ho.cu",
                         tile=list(tile), share_of_bound=bound[0] / ms)
    rows["K8"] = _blockjac_case(fes, ctxg, order, card, rng)
    return rows


def _small_solve(bench, spec, device, case):
    """One IAEA-3D 1x1 float64 solve of ``case`` on ``device``: (k, outers,
    inners), after checking the flux is finite and of the expected shape."""
    import dataclasses

    import torch

    from neutfem_tpu_torch.power import power_iteration

    order = 1 if case == "RT1-P1" else 0
    r = bench.BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device=device, dtype=torch.float64,
                           rt_order=order)
    s = r.solver
    if case == "Jacobi sweep":
        s.set_tol(*bench.SWEEP_TOL)
        res = power_iteration(s._fes, s._ng, dataclasses.replace(s._opts(), sweep="jacobi"),
                              s._ctx, s._flat_phi(), 1.0)
        k, outers, inners = float(res["keff"]), res["outer_iterations"], res["inner_iterations"]
        phi_out = res["phi"]
    else:
        k = r.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
        outers, inners, phi_out = s._last_outers, s._last_inners, s._phi
        if case == "adjoint":
            k = s.SolveAdjoint(use_direct_keff=False)
            hist = s.get_iteration_history()
            outers, inners, phi_out = len(hist), int(hist[:, 3].sum()), s._phi_adj
    P = (order + 1) ** 3
    if tuple(phi_out.shape) != (2, 19, 19, 19, P) or not bool(torch.isfinite(phi_out).all()):
        raise RuntimeError(f"IAEA-3D 1x1 {case} on {device}: bad flux {tuple(phi_out.shape)}")
    return k, outers, inners


def _small_2d_solve(bench, device):
    """One KOEBERG 4x4 float64 solve (68x68 cells, 4 groups; the 2D y and x
    directions) on ``device``: (k, outers, inners), after checking the flux
    is finite and of the expected shape."""
    import torch

    r = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["koeberg2d"], mesh_n=4,
                           device=device, dtype=torch.float64)
    k = r.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
    s = r.solver
    if tuple(s._phi.shape) != (4, 1, 68, 68, 1) or not bool(torch.isfinite(s._phi).all()):
        raise RuntimeError(f"KOEBERG 4x4 on {device}: bad flux {tuple(s._phi.shape)}")
    return k, s._last_outers, s._last_inners


def _fission_rhs(s, g):
    """The first outer's right-hand side of group ``g`` from a flat flux
    (every group at once, (ng, P, ...), for ``g`` None: the Jacobi sweep's)."""
    from neutfem_tpu_torch.ops.apply import phi_to_internal
    from neutfem_tpu_torch.power import _fission_source

    ctx = s._ctx
    fiss = _fission_source(ctx, phi_to_internal(s._flat_phi()))
    return ctx["chi"].unsqueeze(-4) * fiss if g is None else ctx["chi"][g] * fiss


def _graph_case(label, s, opts, g, card, switches=None):
    """One group solve of solver ``s`` (group ``g``; None: the whole context,
    the Jacobi sweep's batched solve) from a cold start: ``group_solve`` (the
    plan's captured graph, kept in the context) once to capture, once timed,
    then the plan's eager block loop at ``BLOCK_ITERS`` on the same card.
    Fails unless both give the same bits and count, the graph solve made
    max(1, ceil(n / BLOCK_ITERS)) host reads, one replay each and no
    capture, and every kernel counter moved by as much as in the eager loop
    (the replays' launches counted as the eager loop launches them).  Every
    counter is set to 0 just before the timed solve; returns what they read
    just after it: the launches of that one solve."""
    import math

    import torch

    from neutfem_tpu_torch import bench, krylov
    from neutfem_tpu_torch.ops import launch_counters
    from neutfem_tpu_torch.power import ctx_group, group_plan, group_solve

    def snap():
        return {k: v for c in launch_counters() for k, v in c.items()}

    fes, ctx = s._fes, s._ctx
    ctx.setdefault(krylov.CG_PLANS, krylov.CGPlans())
    ctxg = ctx if g is None else ctx_group(ctx, g)
    rhs = _fission_rhs(s, g)
    x0 = torch.zeros_like(rhs)
    with bench.env(**(switches or {})):
        group_solve(fes, ctxg, opts, rhs, x0)  # the plan and its capture
        torch.cuda.synchronize()
        krylov.reset_stats()
        for c in launch_counters():
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        got = group_solve(fes, ctxg, opts, rhs, x0)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
        cg = dict(krylov.STATS)
        c1 = snap()
        plan = group_plan(fes, ctxg, opts, rhs)
        if plan.refill is not None:
            plan.refill()
        t0 = time.perf_counter()
        want = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                           tol=opts.inner_tol, maxiter=opts.max_inner, block=krylov.BLOCK_ITERS,
                           **plan.kwargs())
        x_eager = want.x * plan.sdi
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        c2 = snap()
    graph_l = {k: v for k, v in c1.items() if v}
    eager_l = {k: c2[k] - c1[k] for k in c1 if c2[k] != c1[k]}
    n, k = got.iterations, krylov.BLOCK_ITERS
    same = n == want.iterations and torch.equal(got.x, x_eager)
    print(f"  {label}: {n} iterations (eager {want.iterations}), bits "
          f"{'identical' if same else 'DIFFER'}; graph {graph_ms:.3f} ms, {cg['host_reads']} host "
          f"reads ({cg['host_reads'] / max(n, 1):.4f} per iteration), {cg['replays']} replays; "
          f"eager block loop {eager_ms:.3f} ms; launches {graph_l} ({card})")
    if not same:
        raise RuntimeError(f"{label}: the graph and the eager block loop disagree")
    if (cg["host_reads"] != max(1, math.ceil(n / k)) or cg["replays"] != cg["host_reads"]
            or cg["captures"]):
        raise RuntimeError(f"{label}: CG counts {cg} for {n} iterations at block {k}")
    if graph_l != eager_l:
        raise RuntimeError(f"{label}: replay launch counts {graph_l} != eager {eager_l}")
    return graph_l


def _subcritical(bench, spec, mesh, device, dtype, keff_first=True, before=None):
    """IAEA-3D at ``mesh`` with every nu-Sigma_f scaled by 0.9 and a unit
    fast-group source in every fuel cell, in the call sequence of
    examples/subcritical_source.py (SolveKeff, reset_flux, SolveSubcritical;
    ``keff_first`` False skips the first, whose k the reset drops; ``before``
    runs just before SolveSubcritical): (facade, k or None, M,
    SolveSubcritical wall seconds)."""
    import torch

    s = bench.BenchmarkRun(spec, *mesh, device=device, dtype=dtype).solver
    s.get_NSF()[...] *= 0.9
    s.get_SRC()[0] = (s.get_NSF() > 0).any(axis=0)
    s.BuildMatrices()
    s.set_tol(*bench.SWEEP_TOL)
    k = s.SolveKeff() if keff_first else None
    s.reset_flux()
    if s._device.type == "cuda":
        torch.cuda.synchronize()
    if before is not None:
        before()
    t0 = time.perf_counter()
    m = s.SolveSubcritical()
    return s, k, m, time.perf_counter() - t0


def _facade_paths(bench, spec, dev, card, reset_counts, counts, cg_line):
    """Phase [14]: the facade's surface on the card (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from neutfem_tpu_torch.rounding_probe import perturbed_start

    f32, f64 = torch.float32, torch.float64
    data = bench.load_benchmark_data()

    def k14(launches, what):
        """The K1-K4 launches of a path (all of them > 0, none of the replaced)."""
        got = {k: launches.get(k, 0) for k in (*Z_KEYS, "thomas_rows")}
        if min(got.values()) <= 0 or any(launches.get(k, 0) for k in (*Z_OLD, "thomas")):
            raise RuntimeError(f"{what}: K1-K4 launches {got}, or a replaced kernel launched")
        return got

    def on_counts(outers, inners, anchor):
        return (abs(outers - anchor[1]) <= OUTERS_TOL
                and abs(inners - anchor[2]) <= INNERS_REL * anchor[2])

    def perturbed(core, accel):
        """(k, outers, inners) of the row's solves from start fluxes perturbed
        by one float32 ulp (``ACCEL_PERTURB_SEEDS``)."""
        _, kw, tol = next(c for c in bench.ACCEL_CONFIGS if c[0] == core)
        s = bench.BenchmarkRun(data.BENCHMARKS[core], device=dev, dtype=f32, **kw).solver
        s.set_tol(*tol)
        s.set_acceleration(accel)
        out = []
        for seed in ACCEL_PERTURB_SEEDS:
            s.reset_flux()
            perturbed_start(s, 1e-7, seed)
            out.append((s.SolveKeff(), s._last_outers, s._last_inners))
        return out

    # (a) the accelerator matrix; counts of each row's timed solve in the row
    t0 = time.perf_counter()
    print("[14a] accelerator matrix: neutfem_tpu_torch.bench.main_accel(), float32")
    reset_counts()
    rows = bench.main_accel()
    launches = counts()
    cg_line()
    for r in rows:
        what = f"{r['core']} {r['accel']}"
        anchor = ACCEL_ANCHORS[(r["core"], r["accel"])]
        print(f"    {what}: keff {r['keff']}, {r['outer_iterations']} / "
              f"{r['inner_iterations']} (anchor {anchor}); {r['ms_per_outer']:.3f} ms/outer, "
              f"host reads {r['cg']['host_reads_per_iteration']} per CG iteration ({card})")
        runs = [(r["keff"], r["outer_iterations"], r["inner_iterations"])]
        if not on_counts(*runs[0][1:], anchor):
            runs += perturbed(r["core"], r["accel"])
            print(f"    {what}: counts off the anchor; from perturbed start fluxes (k, outers, "
                  f"inners): {runs[1:]}")
        if any(abs(k - anchor[0]) > KEFF_TOL for k, _, _ in runs):
            raise RuntimeError(f"{what}: keff {[k for k, _, _ in runs]} not within {KEFF_TOL} "
                               f"of {anchor[0]}")
        if not any(on_counts(o, i, anchor) for _, o, i in runs):
            raise RuntimeError(f"{what}: no solve within {OUTERS_TOL} outers and "
                               f"{INNERS_REL:.0%} inners of {anchor[1:]}")
        if r["core"] == "iaea3d" and r["accel"] == "anderson":
            print(f"    IAEA-3D 6x6x4 anderson: launches {k14(r['launches'], 'anderson 6x6x4')}")
        if r["core"] != "iaea3d":  # K2 / K3, and K4 or K4′ (by line length) in 2D
            two_d = {k: r["launches"].get(k, 0)
                     for k in ("y_rows", "x_rows", "thomas_rows", "thomas_wide_rows")}
            if (min(two_d["y_rows"], two_d["x_rows"]) <= 0
                    or two_d["thomas_rows"] + two_d["thomas_wide_rows"] <= 0):
                raise RuntimeError(f"{r['core']} {r['accel']}: 2D launches {two_d}")
    k14(launches, "accelerator matrix")
    k_cheb = {r["core"]: r["keff"] for r in rows if r["accel"] == "chebyshev"}
    print(f"    [14a] {time.perf_counter() - t0:.1f} s")

    # (b) the quarter and half cores against the full cores of (a)
    t0 = time.perf_counter()
    for core, mesh, domain, tol in (("iaea3d", (6, 4), "quart_so", bench.ACCEL_CONFIGS[2][2]),
                                    ("iaea2d", (8,), "moitie_s", bench.ACCEL_CONFIGS[0][2])):
        reset_counts()
        run = bench.BenchmarkRun(data.BENCHMARKS[core], *mesh, domain=domain, device=dev,
                                 dtype=f32)
        t1 = time.perf_counter()
        k = run.solve(tol=tol)
        wall = time.perf_counter() - t1
        s = run.solver
        print(f"[14b] {core} {domain} {s._mesh.shape}: keff {k:.7f} (full core {k_cheb[core]}, "
              f"dk {k - k_cheb[core]:+.2e}), {s._last_outers} / {s._last_inners}, "
              f"{wall * 1e3 / max(s._last_outers, 1):.3f} ms/outer ({card})")
        if not abs(k - k_cheb[core]) <= DOMAIN_KEFF_TOL:
            raise RuntimeError(f"{core} {domain}: keff {k} not within {DOMAIN_KEFF_TOL} of the "
                               f"full core's {k_cheb[core]}")
        if core == "iaea3d":
            if s.GetNumElements() != 57 * 57 * 76:
                raise RuntimeError(f"quart_so: {s.GetNumElements()} cells")
            k14(counts(), "quarter core")
        del run, s
    print(f"    [14b] {time.perf_counter() - t0:.1f} s")

    # (c) the subcritical solve at full width, float32 against float64
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    s, k, m32, w32 = _subcritical(bench, spec, (6, 4), dev, f32, before=reset_counts)
    launches = counts()
    cg_line()
    o32 = s.subcritical_outers
    flux_ok = tuple(s._phi.shape) == (2, 76, 114, 114, 1) and bool(torch.isfinite(s._phi).all())
    del s
    s64, _, m64, w64 = _subcritical(bench, spec, (6, 4), dev, f64, keff_first=False)
    o64 = s64.subcritical_outers
    del s64
    print(f"[14c] subcritical IAEA-3D 6x6x4 (nu-Sigma_f x 0.9, unit fast source in the fuel): "
          f"keff {k:.7f}; M {m32:.6f} float32 ({w32:.3f} s, fixed-source outers with / without "
          f"fission {o32}), {m64:.6f} float64 ({w64:.3f} s, {o64}); rel {abs(m32 - m64) / m64:.2e}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    print(f"    SolveSubcritical's launches {k14(launches, 'subcritical solve')}")
    if not (flux_ok and np.isfinite(m32) and m32 > 1.0):
        raise RuntimeError(f"subcritical: M {m32}, flux finite and shaped {flux_ok}")
    if not abs(m32 - m64) <= SUBCRIT_M_REL * m64:
        raise RuntimeError(f"subcritical: float32 M {m32} not within {SUBCRIT_M_REL} of {m64}")
    print(f"    [14c] {time.perf_counter() - t0:.1f} s")

    # (d) the zoom: IAEA-3D 3x3x2 refined (2, 2, 2) onto the main path's mesh
    t0 = time.perf_counter()
    run = bench.BenchmarkRun(spec, 3, 2, device=dev, dtype=f32)
    run.solve(tol=bench.FULL_TOL)
    s = run.solver
    fr = s.project_flux([2, 2, 2])
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zr = s.zoom_resolved([2, 2, 2])
    wall = time.perf_counter() - t1
    launches = counts()
    max_rel = float(np.max(np.abs(zr - fr)) / np.max(np.abs(fr)))
    mean_rel = float(abs(zr.mean() - fr.mean()) / fr.mean())
    print(f"[14d] zoom IAEA-3D 3x3x2 {s._mesh.shape} -> {zr.shape[1:]}: {wall:.3f} s; against "
          f"project_flux max rel {max_rel:.4f} (< 0.25), mean rel {mean_rel:.5f} (< 0.02) ({card})")
    print(f"    launches {k14(launches, 'zoom')}")
    cg_line()
    if zr.shape != (2, 76, 114, 114) or not np.isfinite(zr).all():
        raise RuntimeError(f"zoom: shape {zr.shape} or a non-finite flux")
    if not (max_rel < 0.25 and mean_rel < 0.02):
        raise RuntimeError("zoom: too far from the projected flux")
    del run, s, fr, zr
    print(f"    [14d] {time.perf_counter() - t0:.1f} s")

    # (e) state IO and the VTK export
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = bench.BenchmarkRun(spec, 6, 4, device=dev, dtype=f32)
        k_cold = run.solve(tol=bench.FULL_TOL)
        cold = run.solver._last_outers
        run.solver.save_state(os.path.join(tmp, "state"))
        del run
        fresh = bench.BenchmarkRun(spec, 6, 4, device=dev, dtype=f32).solver
        fresh.load_state(os.path.join(tmp, "state"))
        fresh.set_tol(*bench.FULL_TOL)
        k_warm = fresh.SolveKeff()
        warm = fresh._last_outers
        print(f"[14e] checkpoint IAEA-3D 6x6x4: cold keff {k_cold:.7f} in {cold} outers; loaded "
              f"into a fresh facade, warm keff {k_warm:.7f} in {warm} outers")
        if not (abs(k_warm - k_cold) <= 1e-5 and warm < cold):
            raise RuntimeError("checkpoint: the warm solve is off the saved k or not faster")
        del fresh
        s = bench.BenchmarkRun(spec, 1, 1, device=dev, dtype=f32).solver
        s.set_tol(*bench.FULL_TOL)
        s.SolveKeff()
        s.SolveAdjoint()
        path = os.path.join(tmp, "core")
        s.ExportVTK(path, export_flux=True, export_current=True, export_xs=True,
                    export_adjoint=True)
        with open(path + ".vtk") as f:
            text = f.read()
        missing = [fld for fld in ("Flux_g0", "Flux_g1", "Flux_total", "Flux_adj_g0",
                                   "Current_g0", "D_g0", "SigmaR_g1", "NuSigF_g1", "Chi_g0",
                                   "KappaSigF_g0", "Source_g0", "SigS_0_to_1")
                   if fld not in text]
        print(f"    ExportVTK IAEA-3D 1x1: {len(text)} bytes, missing fields {missing}")
        if missing or f"CELL_DATA {19 ** 3}" not in text:
            raise RuntimeError(f"ExportVTK: fields missing {missing}")
    print(f"    [14e] {time.perf_counter() - t0:.1f} s")

    # (f) IAEA-3D 1x1 float64: the card against the CPU
    t0 = time.perf_counter()
    got = {}
    for device in ("cpu", "cuda"):
        run = bench.BenchmarkRun(spec, 1, 1, device=device, dtype=f64)
        run.solver.set_acceleration("anderson")
        k = run.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
        outers = run.solver._last_outers
        zoom = run.solver.zoom_resolved([2, 2, 2])
        _, _, m, _ = _subcritical(bench, spec, (1, 1), device, f64)
        got[device] = (k, outers, m, zoom)
    (kc, oc, mc, zc), (kg, og, mg, zg) = got["cpu"], got["cuda"]
    zoom_rel = float(np.max(np.abs(zg - zc)) / np.max(np.abs(zc)))
    print(f"[14f] IAEA-3D 1x1 float64, card against CPU: anderson keff {kg!r} / {kc!r} "
          f"({og} / {oc} outers); subcritical M {mg!r} / {mc!r}; zoom (2, 2, 2) rel {zoom_rel:.2e}")
    if not (abs(kg - kc) <= 1e-9 and og == oc and abs(mg - mc) <= 1e-9 * mc
            and zoom_rel <= 1e-9):
        raise RuntimeError("IAEA-3D 1x1: the card disagrees with the CPU")
    print(f"    [14f] {time.perf_counter() - t0:.1f} s")


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

    from neutfem_tpu_torch import bench, krylov
    from neutfem_tpu_torch.ops import (blockjac, cuda_lib, fused, fused_eq, fused_ho,
                                       launch_counters, thomas)
    from neutfem_tpu_torch.power import ctx_group

    def reset_counts():
        for c in launch_counters():
            c.update(dict.fromkeys(c, 0))
        krylov.reset_stats()

    def counts():
        return {k: v for c in launch_counters() for k, v in c.items()}

    def cg_line(cg=None):
        """Print the CG counts of a path (``cg``: a bench row's timed solves,
        default every solve since ``reset_counts``) with its host reads per
        iteration, and check that every CG ran as graph replays, one host read
        a replay, at least one a solve and at most ceil(n / BLOCK_ITERS)."""
        cg = dict(krylov.STATS) if cg is None else cg
        k = krylov.BLOCK_ITERS
        print(f"    CG: {cg['solves']} solves, {cg['iterations']} iterations, "
              f"{cg['host_reads']} host reads ({cg['host_reads'] / max(cg['iterations'], 1):.4f} "
              f"per iteration), {cg['replays']} graph replays, {cg['captures']} captures "
              f"(BLOCK_ITERS {k})")
        if (cg["replays"] != cg["host_reads"] or cg["host_reads"] < cg["solves"]
                or cg["host_reads"] > cg["solves"] + cg["iterations"] / k):
            raise RuntimeError(f"CG counts {cg}: not one graph replay and host read per block")

    t_all = t0 = time.perf_counter()
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
    t0 = time.perf_counter()
    print(f"[3] kernels vs plain, IAEA-3D 6x6x4 {fes.mesh.shape} group 0, float32 ({card})")

    dirs = {di.d: di for di in fes.dirs}
    rows = {}
    for kid, key, d in (("K1", "z", 2), ("K2", "y", 1), ("K3", "x", 0)):
        rows[kid] = _rows_case(kid, key, ctxg, dirs[d], v, acc0, card, "")
    # K1 at the line path's z lines (IAEA-3D 8x8x8: 23,104 lines of 152
    # cells), on random operands of that shape (the time does not depend on
    # the values; phase [8] runs the real ones)
    n8 = (152, 152, 152)
    ctx8 = {"tri_dinvm_d2": torch.as_tensor(rng.uniform(0.2, 0.6, (153, 152, 152)), dtype=f32,
                                            device=dev),
            "tri_l_d2": torch.as_tensor(rng.uniform(-0.3, 0.3, n8), dtype=f32, device=dev)}
    v8, acc8 = (torch.as_tensor(rng.standard_normal((1, *n8)), dtype=f32, device=dev)
                for _ in range(2))
    rows["K1 8x8x8"] = _rows_case("K1", "z", ctx8, dirs[2], v8, acc8, card,
                                  " (IAEA-3D 8x8x8 shape, random operands)")
    del ctx8, v8, acc8

    # K4 at the three compute_current layouts: rhs (2, 1, faces...) per
    # direction, from a random flux through the real factors
    phi = torch.as_tensor(rng.standard_normal((2, *shape)), dtype=f32, device=dev)
    for di in sorted(fes.dirs, key=lambda di: -di.d):
        key = "zyx"[di.axis]
        rows[f"K4 {key}"] = _thomas_rows_case(
            f"compute_current {key} (IAEA-3D 6x6x4)", *_current_operands(fes, ctx, di, phi),
            K4_REPLACES[key], card)
    # K4 at the line preconditioner's z solve (IAEA-3D 8x8x8: 23,104 lines of
    # 152 cells), on random operands of that shape; phase [8] runs the real ones
    r8 = torch.as_tensor(rng.standard_normal((1, *n8)), dtype=f32, device=dev)
    d8 = torch.as_tensor(rng.uniform(0.3, 0.6, (1, *n8)), dtype=f32, device=dev)
    l8 = torch.as_tensor(rng.uniform(-0.4, 0.4, (1, 151, 152, 152)), dtype=f32, device=dev)
    rows["K4 8x8x8"] = _thomas_rows_case("line preconditioner z (IAEA-3D 8x8x8 shape, random "
                                         "operands)", r8, d8, l8, -3, K4_REPLACES["z"], card)
    del r8, d8, l8
    _e4m3_decode_check(dev)

    # K5 and K1's group batch: both groups' flux (2, 1, 76, 114, 114) at once,
    # as the Jacobi sweep's CG hands it to schur_matvec
    bshape = (2, 1, *fes.mesh.shape)
    bv = torch.as_tensor(rng.standard_normal(bshape), dtype=f32, device=dev)
    bacc0 = torch.as_tensor(rng.standard_normal(bshape), dtype=f32, device=dev)
    for kid, key, d, replaces in (
            ("K1 batched", "z", 2, "neutfem_tpu/ops/pallas_fused.py:466"),
            ("K5", "y", 1, "neutfem_tpu/ops/pallas_fused.py:489"),
            ("K5", "x", 0, "neutfem_tpu/ops/pallas_fused.py:704")):
        rows[f"{kid} {key}"] = _batched_case(kid, key, ctx, dirs[d], bv, bacc0, card, "6x6x4",
                                             replaces)
    # a ragged case: 3 groups of a (5, 33, 70) grid, line counts no multiple of 128
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh

    rfes = make_fespace(CartesianMesh.from_breaks(*(np.linspace(0.0, n, n + 1)
                                                    for n in (70, 33, 5))), 0, 0)
    rctx = {}
    for di in rfes.dirs:
        dd = f"d{di.d}"
        fsh = list(rfes.mesh.shape)
        fsh[di.axis] += 1
        dm = torch.as_tensor(rng.uniform(0.2, 0.6, (3, *fsh)), dtype=f32, device=dev)
        ll = torch.as_tensor(rng.uniform(-0.3, 0.3, (3, *rfes.mesh.shape)), dtype=f32,
                             device=dev)
        rctx[f"tri_dinvm_{dd}"], rctx[f"tri_l_{dd}"] = dm, ll
        rctx[f"tri_yT_dinvm_{dd}"] = dm.movedim(2, 1).contiguous()
        rctx[f"tri_yT_l_{dd}"] = ll.movedim(2, 1).contiguous()
        rctx[f"tri_xT_dinvm_{dd}"] = dm.reshape(3, -1, fsh[2]).transpose(1, 2).contiguous()
        rctx[f"tri_xT_l_{dd}"] = ll.reshape(3, -1, rfes.mesh.nx).transpose(1, 2).contiguous()
    rv = torch.as_tensor(rng.standard_normal((3, 1, *rfes.mesh.shape)), dtype=f32, device=dev)
    racc = torch.as_tensor(rng.standard_normal(rv.shape), dtype=f32, device=dev)
    for di in rfes.dirs:
        key = "zyx"[di.axis]
        _batched_case("K5" if key != "z" else "K1 batched", key, rctx, di, rv, racc, card,
                      "ragged", "", timed=False)
    # K7: the five equilibration-folded directions on the same direction
    # operands.  sdi and ce are drawn from [0.5, 2]: the context's ce = C*sdi
    # reaches 2.8e9 in IAEA-3D's absorber cells (IAEA-3D 1x1), where one ulp
    # of ce*y exceeds the contribution's tolerance, and the thread-per-line
    # kernel held beside the tiled one contracts ce*y + contribution into an
    # FMA (two roundings in the plain version and the tiled kernel); phases
    # [4] and [12] run the real ones.
    sdi, ce = (torch.as_tensor(rng.uniform(0.5, 2.0, shape), dtype=f32, device=dev)
               for _ in range(2))
    for key in EQ_REPLACES:
        rows[f"K7 {key}"] = _eq_case(key, ctxg, dirs[EQ_REPLACES[key][0]], v, acc0, sdi, ce,
                                     card)
    del run, ctx, ctxg, rctx
    ho_rows = {}
    for order in (2, 1):  # RT2-P2 first: its rows are the K6 rows of the JSON line
        ho_rows[order] = _ho_kernels(bench, order, card, rng)

    # the 2D slice: K2 / K3 on one group's ZION 48x48 flux (1, 1, 912, 912), and
    # K4′ at compute_current's 2D y layout (2, 1, 1, 913, 912)
    t2 = time.perf_counter()
    zrun = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["zion2d"], mesh_n=48,
                              device=dev, dtype=f32)
    print(f"    ZION 48x48 build: {time.perf_counter() - t2:.1f} s "
          f"({zrun.solver.build_seconds})")
    zfes, zctx = zrun.solver._fes, zrun.solver._ctx
    zctxg = ctx_group(zctx, 0)
    zshape = (1, *zfes.mesh.shape)
    zv = torch.as_tensor(rng.standard_normal(zshape), dtype=f32, device=dev)
    zacc0 = torch.as_tensor(rng.standard_normal(zshape), dtype=f32, device=dev)
    zdirs = {di.d: di for di in zfes.dirs}
    print(f"[3] kernels vs plain, ZION 48x48 {zfes.mesh.shape} group 0, float32 ({card})")
    for kid, key, d in (("K2", "y", 1), ("K3", "x", 0)):
        rows[f"{kid} 2D"] = _rows_case(kid, key, zctxg, zdirs[d], zv, zacc0, card,
                                       " (2D, ZION 48x48)")
    zphi = torch.as_tensor(rng.standard_normal((2, *zshape)), dtype=f32, device=dev)
    rows["K4′"] = _wide_case("compute_current y (ZION 48x48)",
                             *_current_operands(zfes, zctx, zdirs[1], zphi)[:3], card)
    # the 2D line preconditioner's solve: one group's cells (1, 1, 912, 912)
    # through its real factors, on a random residual ([13] runs it in a CG)
    r1 = torch.as_tensor(rng.standard_normal(zshape), dtype=f32, device=dev)
    rows["K4′ line"] = _wide_case(
        "2D line preconditioner (ZION 48x48)", r1,
        zctxg["precond_line_dinv"].unsqueeze(-4).expand(r1.shape).contiguous(),
        zctxg["precond_line_l"].unsqueeze(-4).contiguous(), card)
    del r1
    minv = zctxg["tg"]["schur_minv"]
    rc = torch.as_tensor(rng.standard_normal(minv.shape[0]), dtype=f32, device=dev)
    coarse_ms = _timed(lambda: minv @ rc.to(minv.dtype), 50)
    print(f"  two-grid coarse apply (torch.matmul, {tuple(minv.shape)} {minv.dtype}): "
          f"{coarse_ms:.4f} ms ({card})")
    del zrun, zctx, zctxg, minv
    # K2 / K3 at KOEBERG 32x32: one group's flux (1, 1, 544, 544)
    krun = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["koeberg2d"], mesh_n=32,
                              device=dev, dtype=f32)
    kfes = krun.solver._fes
    kctxg = ctx_group(krun.solver._ctx, 0)
    kshape = (1, *kfes.mesh.shape)
    kv = torch.as_tensor(rng.standard_normal(kshape), dtype=f32, device=dev)
    kacc0 = torch.as_tensor(rng.standard_normal(kshape), dtype=f32, device=dev)
    kdirs = {di.d: di for di in kfes.dirs}
    print(f"[3] kernels vs plain, KOEBERG 32x32 {kfes.mesh.shape} group 0, float32 ({card})")
    for kid, key, d in (("K2", "y", 1), ("K3", "x", 0)):
        rows[f"{kid} KOEBERG"] = _rows_case(kid, key, kctxg, kdirs[d], kv, kacc0, card,
                                            " (2D, KOEBERG 32x32)")
    kphi = torch.as_tensor(rng.standard_normal((4, *kshape)), dtype=f32, device=dev)
    rows["K4′ KOEBERG"] = _wide_case("compute_current y (KOEBERG 32x32)",
                                     *_current_operands(kfes, krun.solver._ctx, kdirs[1],
                                                        kphi)[:3], card)
    del krun, kctxg, kphi
    print(f"    [3] {time.perf_counter() - t0:.1f} s")

    # [4] small input: the GPU (kernels) against the CPU (plain versions), float64
    t0 = time.perf_counter()
    # the tiled kernels a case launches on the GPU, and the old ones it must not
    # (compute_current's K4 in each: the tiled kernel, not the thread-per-line one)
    tiled = {"RT0-P0": ((*Z_KEYS, "thomas_rows"), (*Z_OLD, "thomas")),
             "RT1-P1": ((*HO_KEYS, "thomas_rows"), (*HO_OLD, "thomas")),
             "Jacobi sweep": (("z_batched_rows", *K5_KEYS, "thomas_rows"),
                              ("z_batched", *K5_OLD, "thomas")),
             "adjoint": ((*Z_KEYS, "thomas_rows"), (*Z_OLD, "thomas"))}
    for case in ("RT0-P0", "RT1-P1", "Jacobi sweep", "adjoint"):
        small = {}
        for device in ("cpu", "cuda"):
            reset_counts()
            small[device] = _small_solve(bench, spec, device, case)
        new, old = tiled.get(case, ((), ()))
        launched = {k: counts()[k] for k in (*new, *old)}
        print(f"[4] IAEA-3D 1x1 {case} float64: cuda {small['cuda']}  cpu {small['cpu']}"
              + (f"; launches {launched}" if launched else ""))
        if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
                or small["cuda"][1] != small["cpu"][1]
                or abs(small["cuda"][2] - small["cpu"][2]) > 2
                or any(launched[k] <= 0 for k in new) or any(launched[k] for k in old)):
            raise RuntimeError(f"IAEA-3D 1x1 {case}: the GPU solve disagrees with the "
                               "CPU reference, or the tiled kernels did not serve it")
    for mode in EQ_MODES:  # the equilibration-folded matvec (K7) on the GPU
        small = {}
        reset_counts()
        with bench.env(NEUTFEM_EQFOLD=mode):
            for device in ("cpu", "cuda"):
                small[device] = _small_solve(bench, spec, device, "RT0-P0")
        launched = {k: counts()[k] for k in EQ_MODES[mode][0]}
        idle = {k: counts()[k] for k in EQ_MODES[mode][1] if counts()[k]}
        print(f"[4] IAEA-3D 1x1 RT0-P0 float64 NEUTFEM_EQFOLD={mode}: cuda {small['cuda']}  "
              f"cpu {small['cpu']}; K7 launches {launched}")
        if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
                or small["cuda"][1] != small["cpu"][1]
                or abs(small["cuda"][2] - small["cpu"][2]) > 2
                or min(launched.values()) < small["cuda"][2] or idle):
            raise RuntimeError(f"IAEA-3D 1x1 NEUTFEM_EQFOLD={mode}: the GPU solve disagrees "
                               "with the CPU reference, or the tiled K7 did not run every CG "
                               f"iteration, or an idle kernel launched ({idle})")
    small = {}
    for device in ("cpu", "cuda"):  # the 2D directions: the tiled K2 / K3 kernel
        fused.reset_launches()
        small[device] = _small_2d_solve(bench, device)
    launched = {k: fused.LAUNCHES[k] for k in ("y_rows", "x_rows", "y", "x")}
    print(f"[4] KOEBERG 4x4 float64: cuda {small['cuda']}  cpu {small['cpu']}; K2 / K3 launches "
          f"{launched}")
    if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
            or small["cuda"][1] != small["cpu"][1]
            or abs(small["cuda"][2] - small["cpu"][2]) > 2
            or min(launched["y_rows"], launched["x_rows"]) < small["cuda"][2]
            or launched["y"] or launched["x"]):
        raise RuntimeError("KOEBERG 4x4: the GPU solve disagrees with the CPU reference, or the "
                           "tiled K2 / K3 kernel did not run every CG iteration")
    print(f"    [4] {time.perf_counter() - t0:.1f} s")

    # [5] the RT0 main path; counts are zeroed just before it and read just after
    t0 = time.perf_counter()
    reset_counts()
    print("[5] main path: neutfem_tpu_torch.bench.main(6, 4), float32")
    res = bench.main(6, 4)
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff} (anchor {KEFF_ANCHOR}), outers {outers} ({OUTERS_ANCHOR}), "
          f"inners {inners} ({INNERS_ANCHOR}); {res['value'] * 1e3:.3f} ms/outer ({card})")
    _check_anchor("RT0-P0 6x6x4", keff, outers, inners,
                  (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
    keff_main = keff
    if any(launches[k] for k in (*fused_eq.LAUNCHES, *blockjac.LAUNCHES)):
        raise RuntimeError("main path: an opt-in kernel (K7, K8) launched without its switch")
    if any(launches[k] for k in Z_OLD):
        raise RuntimeError("main path: a thread-per-line kernel served z, y or x")
    if launches["thomas"]:
        raise RuntimeError("main path: the thread-per-line K4 launched")
    for rid in ("K1", "K2", "K3", "K4 z", "K4 y", "K4 x"):
        row = rows[rid]
        row["launches"] = launches[row.pop("key")]
        if row["launches"] <= 0:
            raise RuntimeError(f"{row['name']}: not launched on the main path")
    print(f"    [5] {time.perf_counter() - t0:.1f} s")

    # [6] the higher-order paths, each with its own counts
    for order in (1, 2):
        t0 = time.perf_counter()
        reset_counts()
        print(f"[6] higher-order path: neutfem_tpu_torch.bench.main_ho({order}), float32")
        res = bench.main_ho(order)
        launches = counts()
        print(f"    launches {launches}")
        cg_line(res["detail"]["cg"])
        det = res["detail"]
        keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
        print(f"    keff {keff}, outers {outers}, inners {inners} (anchors "
              f"{HO_ANCHORS[order]}); {res['value'] * 1e3:.3f} ms/outer ({card})")
        _check_anchor(f"RT{order}-P{order} 4x4x2", keff, outers, inners, HO_ANCHORS[order])
        if not det["converged_not_capped"]:
            raise RuntimeError(f"RT{order}-P{order}: the solve hit max_outer")
        for key in (*HO_KEYS, "thomas_rows"):
            if launches[key] <= 0:
                raise RuntimeError(f"RT{order}-P{order}: {key} not launched on the path")
        if launches["blockjac_dev"] < inners:
            raise RuntimeError(f"RT{order}-P{order}: the E-form K8 launched "
                               f"{launches['blockjac_dev']} times for {inners} CG iterations")
        for key in HO_OLD:
            if launches[key] != 0:
                raise RuntimeError(f"RT{order}-P{order}: the thread-per-(mode, line) K6 {key} "
                                   f"launched {launches[key]} times")
        for key in ("z", "y", "x"):
            row = ho_rows[order][key]
            row["launches"] = launches[row.pop("key")]
            rows[f"K6 {key}" + ("" if order == 2 else f" RT{order}")] = row
        for key in ("blockjac", "blockjac_tiled", "thomas"):
            if launches[key] != 0:
                raise RuntimeError(f"RT{order}-P{order}: {key} launched {launches[key]} times on "
                                   "the default path")
        row = ho_rows[order]["K8"][0]
        row["launches"] = launches[row.pop("key")]
        rows[f"K8 E-form RT{order}"] = row
        print(f"    [6] RT{order} {time.perf_counter() - t0:.1f} s")

    # [7] the 2D paths, each with its own counts; the 2D kernel rows take the
    # counts of both
    launches_2d = {}
    for core in ("koeberg2d", "zion2d"):
        t0 = time.perf_counter()
        reset_counts()
        print(f"[7] 2D path: neutfem_tpu_torch.bench.main_2d({core!r}, {MESH_2D[core]}), float32")
        res = bench.main_2d(core, MESH_2D[core])
        launches = counts()
        print(f"    launches {launches}")
        cg_line(res["detail"]["cg"])
        det = res["detail"]
        keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
        print(f"    keff {keff}, outers {outers}, inners {inners} (anchors "
              f"{ANCHORS_2D[core]}); {res['value'] * 1e3:.3f} ms/outer, "
              f"{inners / max(outers, 1):.1f} inners/outer ({card})")
        _check_anchor(f"{core} {MESH_2D[core]}x{MESH_2D[core]}", keff, outers, inners,
                      ANCHORS_2D[core])
        # "twogrid" is what the facade resolves "auto" to when, and only when,
        # BuildMatrices attached the coarse level "tg" to the context
        if det["preconditioner"] != "twogrid":
            raise RuntimeError(f"{core}: the context carries no two-grid level "
                               f"(preconditioner {det['preconditioner']!r})")
        for key in ("y_rows", "x_rows", "thomas_wide_rows"):
            if launches[key] <= 0:
                raise RuntimeError(f"{core}: {key} not launched on the 2D path")
        for key in ("y", "x", "thomas_y"):
            if launches[key] != 0:
                raise RuntimeError(f"{core}: the replaced kernel {key} launched "
                                   f"{launches[key]} times")
        launches_2d[core] = launches
        print(f"    [7] {core} {time.perf_counter() - t0:.1f} s")
    for rid, core in (("K2 2D", "zion2d"), ("K3 2D", "zion2d"), ("K2 KOEBERG", "koeberg2d"),
                      ("K3 KOEBERG", "koeberg2d")):
        rows[rid]["launches"] = launches_2d[core][rows[rid].pop("key")]
    for rid, core in (("K4′", "zion2d"), ("K4′ KOEBERG", "koeberg2d")):
        rows[rid]["launches"] = launches_2d[core][rows[rid].pop("key")]

    # [8] the line path
    t0 = time.perf_counter()
    reset_counts()
    print("[8] line path: neutfem_tpu_torch.bench.main_scale() (IAEA-3D 8x8x8), float32")
    res = bench.main_scale()
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff}, outers {outers}, inners {inners} (anchors {SCALE_ANCHOR}); "
          f"{res['value'] * 1e3:.3f} ms/outer ({card})")
    _check_anchor("IAEA-3D 8x8x8", keff, outers, inners, SCALE_ANCHOR, SCALE_KEFF_TOL)
    if det["preconditioner"] != "line":
        raise RuntimeError(f"IAEA-3D 8x8x8: preconditioner {det['preconditioner']!r}, not line")
    if launches["thomas_rows"] < inners or launches["thomas"]:
        raise RuntimeError(f"IAEA-3D 8x8x8: {launches['thomas_rows']} tiled z Thomas launches "
                           f"for {inners} CG iterations, {launches['thomas']} thread-per-line")
    rows["K4 8x8x8"]["launches"] = launches[rows["K4 8x8x8"].pop("key")]
    if any(launches[k] < inners for k in Z_KEYS) or any(launches[k] for k in Z_OLD):
        raise RuntimeError("IAEA-3D 8x8x8: the tiled K1-K3 did not serve every CG iteration")
    rows["K1 8x8x8"]["launches"] = launches[rows["K1 8x8x8"].pop("key")]
    print(f"    [8] {time.perf_counter() - t0:.1f} s")

    # [9] the Jacobi path: the Gauss-Seidel solve at the same tolerances first
    # (its own, uncounted run), then the Jacobi sweep with its counts
    t0 = time.perf_counter()
    run = bench.BenchmarkRun(spec, mesh_n=6, mesh_nz=4, device=dev, dtype=f32)
    print("[9] Jacobi path: neutfem_tpu_torch.bench.main_sweep('jacobi') (IAEA-3D 6x6x4), "
          "float32")
    gs = bench.main_sweep("gs", run=run)["detail"]
    reset_counts()
    res = bench.main_sweep("jacobi", run=run)
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    print(f"    keff {det['keff']} (Gauss-Seidel at the same tolerances {gs['keff']}, "
          f"{gs['outer_iterations']} / {gs['inner_iterations']}; phase [5] {keff_main}), "
          f"outers {det['outer_iterations']}, inners {det['inner_iterations']}; "
          f"{res['value'] * 1e3:.3f} ms/outer, "
          f"{det['solve_wall_s'] * 1e3 / max(det['inner_iterations'], 1):.3f} ms/inner ({card})")
    if not det["converged_not_capped"]:
        raise RuntimeError("Jacobi sweep: the solve hit max_outer")
    for what, k_ref in (("the Gauss-Seidel solve at the same tolerances", gs["keff"]),
                        ("phase [5]", keff_main)):
        if not abs(det["keff"] - k_ref) <= SWEEP_KEFF_TOL:
            raise RuntimeError(f"Jacobi sweep: keff {det['keff']} is not within "
                               f"{SWEEP_KEFF_TOL} of {what} ({k_ref})")
    for key in ("z_batched_rows", *K5_KEYS):
        if launches[key] <= 0:
            raise RuntimeError(f"Jacobi sweep: {key} not launched on the path")
    for key in (*Z_OLD, *Z_KEYS, "z_batched", *K5_OLD):
        if launches[key] != 0:
            raise RuntimeError(f"Jacobi sweep: the one-group or thread-per-line batched kernel "
                               f"{key} launched {launches[key]} times")
    for rid in ("K1 batched z", "K5 y", "K5 x"):
        rows[rid]["launches"] = launches[rows[rid].pop("key")]
    print(f"    [9] {time.perf_counter() - t0:.1f} s")

    # [10] the adjoint path
    t0 = time.perf_counter()
    reset_counts()
    print("[10] adjoint path: neutfem_tpu_torch.bench.main_adjoint() (IAEA-3D 6x6x4), float32")
    res = bench.main_adjoint()
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    print(f"    keff_adjoint {det['keff_adjoint']}, keff_direct {det['keff_direct']} (anchors "
          f"{ADJOINT_ANCHOR}), outers {det['outer_iterations']}, inners "
          f"{det['inner_iterations']}, adjoint_vs_direct_pcm {det['adjoint_vs_direct_pcm']}; "
          f"{res['value'] * 1e3:.3f} ms/outer ({card})")
    ka, kd, oa = ADJOINT_ANCHOR
    if not (abs(det["keff_adjoint"] - ka) <= ADJ_KEFF_TOL
            and abs(det["keff_direct"] - kd) <= ADJ_KEFF_TOL):
        raise RuntimeError("adjoint: keff not within the anchors' tolerance")
    if not abs(det["outer_iterations"] - oa) <= OUTERS_TOL:
        raise RuntimeError(f"adjoint: {det['outer_iterations']} outers, expected {oa} +- "
                           f"{OUTERS_TOL}")
    for key in (*Z_KEYS, "thomas_rows"):
        if launches[key] <= 0:
            raise RuntimeError(f"adjoint: {key} not launched on the path")
    if any(launches[k] for k in (*Z_OLD, "thomas")):
        raise RuntimeError("adjoint: a thread-per-line kernel served z, y, x or K4")
    print(f"    [10] {time.perf_counter() - t0:.1f} s")

    # [11] the facade's variants: one timed solve each from a cold flux, at
    # bench.SWEEP_TOL.  At FULL_TOL the CG's 1e-4 inner tolerance moves k by
    # up to ~4e-5 against an exact group solve, and each variant stops on its
    # own side of the fixed point (float32 on a CPU: CMFD -2.4e-5 and coarse
    # init -2.9e-5 from Chebyshev at IAEA-3D 2x2x2, DIRECT_LLT +2.0e-5 from CG
    # at IAEA-2D 3x3); at SWEEP_TOL -1.2e-7, +2.9e-6 and +1.4e-6
    t0 = time.perf_counter()
    s = run.solver
    s.set_tol(*bench.SWEEP_TOL)
    print("[11] facade variants, IAEA-3D 6x6x4 float32")

    def timed_solve(**kw):
        s.reset_flux()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k = s.SolveKeff(**kw)
        return k, s._last_outers, s._last_inners, time.perf_counter() - t1

    k_cheby, o, i, w = timed_solve()
    reset_counts()
    print(f"    Chebyshev: keff {k_cheby:.7f}, {o} / {i}, {w * 1e3 / o:.3f} ms/outer ({card})")
    k, o, i, w = timed_solve(use_cmfd=True)
    capped = " (stopped at max_outer)" if o >= bench.SWEEP_TOL[3] else ""
    print(f"    CMFD: keff {k:.7f} (dk {k - k_cheby:+.2e}), {o} / {i}{capped}, "
          f"{w * 1e3 / o:.3f} ms/outer ({card})")
    if not abs(k - k_cheby) <= VARIANT_KEFF_TOL:
        raise RuntimeError(f"CMFD: keff {k} not within {VARIANT_KEFF_TOL} of {k_cheby}")
    k_coarse, _ = s.SolveCoarse((3, 3, 4))
    k, o, i, w = timed_solve(use_coarse_init=True, coarse_factors=(3, 3, 4))
    print(f"    coarse init (3, 3, 4): coarse keff {k_coarse:.7f}; keff {k:.7f} "
          f"(dk {k - k_cheby:+.2e}), {o} / {i}, {w * 1e3 / o:.3f} ms/outer ({card})")
    if not abs(k - k_cheby) <= VARIANT_KEFF_TOL:
        raise RuntimeError(f"coarse init: keff {k} not within {VARIANT_KEFF_TOL} of {k_cheby}")
    launches = counts()
    print(f"    CMFD and coarse init: launches {launches}")
    cg_line()
    if (any(launches[k] <= 0 for k in (*Z_KEYS, "thomas_rows"))
            or any(launches[k] for k in (*Z_OLD, "thomas"))):
        raise RuntimeError("CMFD / coarse init: the tiled K1-K3 did not serve them")
    del run, s
    d2 = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["iaea2d"], mesh_n=3,
                            device=dev, dtype=f32)
    s = d2.solver
    s.set_tol(*bench.SWEEP_TOL)
    k_cg = s.SolveKeff()
    s.reset_flux()
    s.set_linear_solver(bench.LinearSolverType.DIRECT_LLT)
    t1 = time.perf_counter()
    k_direct = s.SolveKeff()
    w = time.perf_counter() - t1
    print(f"    DIRECT_LLT IAEA-2D 3x3 ({s._fes.n_phi} flux DOFs): keff {k_direct:.7f}, CG "
          f"{k_cg:.7f} (dk {k_direct - k_cg:+.2e}), {s._last_outers} outers, "
          f"{w * 1e3 / max(s._last_outers, 1):.3f} ms/outer ({card})")
    if "schur_chol" not in s._ctx or not abs(k_direct - k_cg) <= DIRECT_KEFF_TOL:
        raise RuntimeError("DIRECT_LLT: no dense factors, or keff off its CG k")
    print(f"    [11] {time.perf_counter() - t0:.1f} s")

    # [12] the opt-in paths, each under its switches and with its own counts
    for mode, (eq_keys, idle) in EQ_MODES.items():
        t0 = time.perf_counter()
        reset_counts()
        print(f"[12] NEUTFEM_EQFOLD={mode}: neutfem_tpu_torch.bench.main(6, 4), float32")
        with bench.env(NEUTFEM_EQFOLD=mode):
            res = bench.main(6, 4)
        launches = counts()
        print(f"    launches {launches}")
        cg_line(res["detail"]["cg"])
        det = res["detail"]
        keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
        print(f"    keff {keff}, outers {outers}, inners {inners}; {res['value'] * 1e3:.3f} "
              f"ms/outer (phase [5], default matvec: see above; {card})")
        _check_anchor(f"RT0-P0 6x6x4 NEUTFEM_EQFOLD={mode}", keff, outers, inners,
                      (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
        for key in eq_keys:
            if launches[key] < inners:
                raise RuntimeError(f"NEUTFEM_EQFOLD={mode}: {key} launched {launches[key]} "
                                   f"times for {inners} CG iterations")
            row = rows[f"K7 {key.removesuffix('_rows')}"]
            row["launches"] = launches[row.pop("key")]
        for key in idle:
            if launches[key] != 0:
                raise RuntimeError(f"NEUTFEM_EQFOLD={mode}: the kernel {key} "
                                   f"launched {launches[key]} times")
        print(f"    [12] EQFOLD={mode} {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reset_counts()
    print("[12] NEUTFEM_BLKFP8=0 NEUTFEM_BLOCKJAC=1: neutfem_tpu_torch.bench.main_ho(1), float32")
    with bench.env(NEUTFEM_BLKFP8="0", NEUTFEM_BLOCKJAC="1"):
        res = bench.main_ho(1)
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff}, outers {outers}, inners {inners} (anchors {HO_ANCHORS[1][:2]}, "
          f"{BLOCKJAC_INNERS}); block storage {det['block_precond']}; "
          f"{res['value'] * 1e3:.3f} ms/outer ({card})")
    if det["block_precond"] != {"precond_blk_inv": "torch.bfloat16"}:
        raise RuntimeError(f"NEUTFEM_BLKFP8=0: block storage {det['block_precond']}")
    _check_anchor("RT1-P1 4x4x2 NEUTFEM_BLOCKJAC=1", keff, outers, inners,
                  (HO_ANCHORS[1][0], HO_ANCHORS[1][1], BLOCKJAC_INNERS))
    if launches["blockjac_tiled"] < inners or launches["blockjac"] or launches["blockjac_dev"]:
        raise RuntimeError(f"NEUTFEM_BLOCKJAC=1: K8 launched {launches['blockjac_tiled']} times "
                           f"(thread per cell {launches['blockjac']}, E-form "
                           f"{launches['blockjac_dev']}) for "
                           f"{inners} CG iterations")
    if any(launches[k] <= 0 for k in HO_KEYS) or any(launches[k] for k in HO_OLD):
        raise RuntimeError("NEUTFEM_BLOCKJAC=1: the tiled K6 did not serve every direction")
    for order in (2, 1):
        row = ho_rows[order]["K8"][1]
        row["launches"] = launches[row.pop("key")]
        rows[f"K8 bf16 RT{order}"] = row
    print(f"    [12] BLOCKJAC {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reset_counts()
    print("[12] NEUTFEM_CGCG=1: neutfem_tpu_torch.bench.main(6, 4), float32")
    with bench.env(NEUTFEM_CGCG="1"):
        res = bench.main(6, 4)
    launches = counts()
    print(f"    launches {launches}")
    cg_line(res["detail"]["cg"])
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff}, outers {outers}, inners {inners}; {res['value'] * 1e3:.3f} ms/outer "
          f"({card})")
    _check_anchor("RT0-P0 6x6x4 NEUTFEM_CGCG=1", keff, outers, inners,
                  (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
    for key in (*Z_KEYS, "thomas_rows"):
        if launches[key] <= 0:
            raise RuntimeError(f"NEUTFEM_CGCG=1: {key} not launched on the path")
    if any(launches[k] for k in (*Z_OLD, "thomas")):
        raise RuntimeError("NEUTFEM_CGCG=1: a thread-per-line kernel served z, y, x or K4")
    print(f"    [12] CGCG {time.perf_counter() - t0:.1f} s")

    # [13] the CG's captured blocks against the eager block loop on the card
    t0 = time.perf_counter()
    from neutfem_tpu_torch.power import SolveOptions

    print(f"[13] CG graphs vs the eager block loop (BLOCK_ITERS {krylov.BLOCK_ITERS}), one cold "
          "group solve each, float32")
    run = bench.BenchmarkRun(spec, mesh_n=6, mesh_nz=4, device=dev, dtype=f32)
    s = run.solver
    s.set_tol(*bench.FULL_TOL)
    _graph_case("IAEA-3D 6x6x4 RT0 group 0", s, s._opts(), 0, card)
    _graph_case("IAEA-3D 6x6x4 Jacobi sweep (both groups)", s, s._opts(), None, card)
    _graph_case("IAEA-3D 6x6x4 NEUTFEM_CGCG=1 group 0", s, s._opts(), 0, card,
                {"NEUTFEM_CGCG": "1"})
    del run, s
    with bench.env(NEUTFEM_EQFOLD="2"):
        run = bench.BenchmarkRun(spec, mesh_n=6, mesh_nz=4, device=dev, dtype=f32)
    s = run.solver
    s.set_tol(*bench.FULL_TOL)
    _graph_case("IAEA-3D 6x6x4 NEUTFEM_EQFOLD=2 group 0", s, s._opts(), 0, card,
                {"NEUTFEM_EQFOLD": "2"})
    del run, s
    run = bench.BenchmarkRun(spec, mesh_n=4, mesh_nz=2, device=dev, dtype=f32, rt_order=2)
    s = run.solver
    s.set_tol(*bench.HO_TOL)
    graph_l = _graph_case("IAEA-3D 4x4x2 RT2-P2 group 0 (K8 E-form)", s, s._opts(), 0, card)
    if graph_l.get("blockjac_dev", 0) <= 0:
        raise RuntimeError("RT2-P2 group solve: K8 on the E-form did not run in the graph")
    del run, s
    run = bench.BenchmarkRun(bench.load_benchmark_data().BENCHMARKS["zion2d"], mesh_n=48,
                             device=dev, dtype=f32)
    s = run.solver
    s.set_tol(*bench.FULL_TOL)
    if s.preconditioner() != "twogrid":
        raise RuntimeError(f"ZION 48x48: preconditioner {s.preconditioner()!r}, not twogrid")
    _graph_case("ZION 48x48 group 0 (two-grid)", s, s._opts(), 0, card)
    line_opts = dataclasses.replace(s._opts(), inner_precond="line")
    graph_l = _graph_case("ZION 48x48 group 0 (line preconditioner: K4′)", s, line_opts, 0, card)
    # the launches of the one timed line-preconditioned group solve
    rows["K4′ line"]["launches"] = graph_l.get(rows["K4′ line"].pop("key"), 0)
    if graph_l.get("thomas_wide_rows", 0) <= 0 or graph_l.get("thomas_y", 0):
        raise RuntimeError("ZION line preconditioner: the tiled K4′ did not run in the graph")
    del run, s
    print(f"    [13] {time.perf_counter() - t0:.1f} s")

    # [14] the facade's surface: each part with its own counts
    _facade_paths(bench, spec, dev, card, reset_counts, counts, cg_line)
    print(f"    total {time.perf_counter() - t_all:.1f} s")

    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
