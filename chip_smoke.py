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
   bfloat16, the kernels' e4m3 widening of all 254 finite bytes against
   torch's, and the CG step's two kernels (csrc/cg_step.cu) at the
   benchmark cells' vector lengths, bit for bit, timed beside the ATen step
   they replaced; float32.  K2 and K3 are the tiled kernel of csrc/fused_rows.cu,
   K5 its group-batched form; K1 and its batch the face-major tiled kernels
   of csrc/fused_z_rows.cu; K4 the tiled kernel of csrc/thomas_rows.cu; K6
   the tiled kernel of csrc/fused_ho_rows.cu, K7 that of
   csrc/fused_eq_rows.cu; K8 that of csrc/blockjac_tiled.cu; K4′ that of
   csrc/thomas_wide_rows.cu; at each of their shapes the kernel is held to
   the plain version and timed queued behind a sleep, and swept over the
   tiles of ``Z_SWEEP`` (z lines: K1, its batch, K7's z variants, and every
   K4 layout; for K1 also K2's kernel at the z strides), ``ROWS_SWEEP`` (K2,
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
   34 outers, 1068 inners), with every kernel's launch count > 0 and the
   CG step's two kernels (``cgstep.cg_xr``, ``cgstep.cg_p``) printed and
   launched;
6. higher-order paths: ``bench.main_ho(1)`` and ``bench.main_ho(2)`` (IAEA-3D
   4x4x2, float32) against the JAX package's RT1-P1 / RT2-P2 anchors, with
   the tiled K6 (every direction) and the tiled K4 launched in each, K8 on
   the fp8 E-form at least once per CG iteration, and the inverse-form K8
   not at all;
7. 2D paths: ``bench.main_2d("koeberg2d", 32)`` and ``main_2d("zion2d", 48)``
   (float32) against the JAX package's anchors, with the two-grid coarse
   level attached (the group solves resolve "auto" to "twogrid"), the tiled
   y and x kernels and the tiled K4′ launched in each;
8. line path: ``bench.main_scale()`` (IAEA-3D 8x8x8, 3.5M cells, float32)
   against its anchor (k within 2e-5, ``SCALE_KEFF_TOL``), with the line
   preconditioner: at least one tiled z Thomas launch (K4) per CG
   iteration;
9. Jacobi path: ``bench.main_sweep("jacobi")`` (IAEA-3D 6x6x4, float32, every
   group in one batched CG): the batched kernels (the tiled K5, K1's batch)
   launched, the one-group K1-K3 not, converged below 600 outers, k within 2e-5
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
   iteration and the one-group x and z kernels (and y in mode 2) not at
   all;
   ``bench.main_ho(1)`` under ``NEUTFEM_BLKFP8=0 NEUTFEM_BLOCKJAC=1`` with
   bfloat16 block storage, the tiled K8 on the inverse launched at least
   once per CG iteration (the E-form not), the tiled K6 in every
   direction, at the
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
   the same outers), M and the zoomed flux (rel 1e-9);
15. the last single-device solver features (``bench.main_variants``), each
   run with its own counts: (a) the diagonal and lumped A-solves and the
   elementwise bug-compat solve on IAEA-3D 6x6x4 (K1-K4 not launched: the
   JAX package runs no kernel there either; the bug-compat solve warns and
   runs 0 inners), and the first two at 3x3x2 on the JAX package's float32
   anchors (``DIAG_ANCHOR``, ``LUMPED_ANCHOR``; k 1e-5, outers +-3, inners
   +-15%); (b) IAEA-3D 6x6x4 with its four lateral faces PERIODIC within 2e-5
   of the quadrant (``quart_so``, 57x57x76) with all four MIRROR, K4 launched
   at least twice a CG iteration, K1 at least once, the one-group K2 / K3
   not at all; (c) the same at RT1-P1 4x4x2, K6 in z only; (d) a subcritical
   solve driven by an inward current q = 1 on the bottom face (NEUMANN), M at
   float32 within 1e-3 of float64, the bottom current q within 1e-5, K1-K4
   launched; (e) BiCGSTAB at float64 within 2e-5 of the CG (6x6x4, at
   ``bench.SWEEP_TOL``), K1-K3 launched twice a BiCGSTAB iteration, graph
   replays, at most 0.3 host reads an iteration, and at 3x3x2 on the JAX
   package's float64 anchor (``BICGSTAB_ANCHOR``; float32 BiCGSTAB overflows
   from the flat flux in both packages, so its 6x6x4 row and CMFD "wielandt"
   are printed, not held); (f) IAEA-3D 1x1 at float64, the card against the
   CPU, for every feature of (a)-(e), CMFD "wielandt" on a small 2D problem
   where its eigensolve converges, and KOEBERG 4x4 with both y faces PERIODIC (|dk| <= 1e-9, M
   and flux rel 1e-9, the same outers); (g) KOEBERG 32x32 with both y faces
   PERIODIC (its cyclic y solve takes K4′'s layout, launched every CG
   iteration) within 2e-5 of the half core (``moitie_s``) with both y faces
   MIRROR; K4′ at that fold shape and K4 at [15b]'s x and y fold shapes
   against the plain version (rows of the JSON line).

16. the multi-device solve (``neutfem_tpu_torch/parallel.py``), each path
   with its own counts: (a) the NCCL world of one in this process,
   IAEA-3D 6x6x4 RT0-P0 float32 with a z cut and with a y cut, on [5]'s
   anchors, the CG replaying its graphs (the collectives captured in them),
   K4 at least once a CG iteration (the segment solve) and the uncut
   directions' kernels every iteration (K1 on the y cut), ms/outer beside
   the unsharded solve's from the same call; (b) RT1-P1 4x4x2, z cut, on
   ``main_ho(1)``'s anchors with K6 in x and y, K4 and K8 on the E-form
   every CG iteration; (c) two ranks in processes of their own sharing the
   card over gloo (host-staged: the eager CG block loop), IAEA-3D 6x6x4 z
   cut (38 planes a rank), k within 2e-5 and the gathered flux within 1e-4
   of the unsharded solve, k and the counts identical on both ranks, K2-K4
   every CG iteration on each (K1's direction is the cut one), the bytes
   staged and ms/outer printed as transport-bound.  After each solve of
   (a)-(c), K4 at that path's segment shape (T transverse modes, the rank's
   s body faces along the cut, its slab across: (1, 76, 114, 114) on both
   cuts of (a), (4, 38, 76, 76) in (b), (1, 38, 114, 114) in (c)) with the
   rank's own segment factors, and in (c) K2 / K3 on rank 0's restaged
   slab operands (1, 38, 114, 114), against the plain version (rows of the
   JSON line, with the path's launches); (d) float64 card against the CPU's unsharded solve
   (|dk| <= 1e-9, the same outers, flux rel 1e-9): IAEA-3D 1x1 on the NCCL
   world of one, IAEA-3D 1x1x2 on the two gloo ranks (1x1 has 19 cells on
   every axis: no even cut).  A failing rank kills the other and fails.
17. the solver variants under a sharding scope (``parallel.shard_context``,
   ``shardctx.sharding_scope``), each path with its own counts: (a) the NCCL
   world of one, IAEA-3D 6x6x4 RT0-P0 float32, each variant sharded (z cut
   unless stated) and unsharded in this call with its ms/outer: the Jacobi
   sweep on a z and a y cut within SWEEP_KEFF_TOL of the unsharded Jacobi k
   (K5 y / x and K4 every CG iteration on the z cut, K1's batch and K5 x on
   the y cut), CMFD "fixed" and coarse init (3, 3, 4) within
   VARIANT_KEFF_TOL of the Chebyshev k, Anderson on ``ACCEL_ANCHORS``' row
   (k; its counts in a rounding basin of the unsharded solve's, flat and
   perturbed starts), BiCGSTAB at float64 within VARIANT_PAIR_TOL of the
   float64 CG, [14c]'s subcritical M within SUBCRIT_M_REL of the float64 M,
   the diag / lumped A-solves on ``DIAG_ANCHOR`` / ``LUMPED_ANCHOR`` at
   3x3x2 and beside the unsharded solve at 6x6x4 (no K1-K4), DIRECT_LLT on
   IAEA-2D 3x3 (y cut) within DIRECT_KEFF_TOL of its CG k; every CG
   replaying its graphs; (c) K5 y / x, K1's batch and K4 at rank 0's slab
   of a two-way cut of 6x6x4 ((2, 1, 38, 114, 114) on a z cut, (2, 1, 76,
   57, 114) on a y cut; K4 at the group-batched segment) against the plain
   version, with (a)'s Jacobi launches; (b) two gloo ranks sharing the card,
   float64, every variant against the unsharded run on the CPU (|dk| <=
   1e-9, the same outers, flux rel 1e-9, CMFD's 1e-6; k, counts and history
   the same on both ranks): IAEA-3D 1x1x2 z cut; CMFD (three outers),
   BiCGSTAB and DIRECT_LLT on IAEA-2D 2x2 and CMFD "wielandt" on 6x4 cells,
   each a y cut (``V17B``).
18. the scan cut-axis solve (``ops/parttri.tridiag_solve_scan``: where the
   JAX package takes its associative scan), each path with its own counts:
   (a) the NCCL world of one, IAEA-3D 6x6x4 RT0-P0 float32 at
   ``bench.FULL_TOL``, a z and a y cut under ``NEUTFEM_PARTTRI=0`` beside
   the partitioned cut in this call, each on [5]'s anchors with its
   ms/outer: the scan applied at least once a CG iteration and the
   partitioned solve not at all (and the reverse on the partitioned path),
   the uncut directions' kernels (K1-K3) every CG iteration, the CG
   replaying its graphs; (b) a PERIODIC cut direction, y cut, at
   ``bench.SWEEP_TOL``: IAEA-3D 6x6x4 with [15b]'s lateral faces PERIODIC
   within SHARD_KEFF_TOL of its unsharded run and VARIANT_PAIR_TOL of the
   MIRROR quadrant, KOEBERG 32x32 y PERIODIC within VARIANT_PAIR_TOL of
   [15g]'s half core; (c) two gloo ranks sharing the card, float64, each
   case against the unsharded run on the CPU (|dk| <= 1e-9, the same
   outers, flux rel 1e-9, k, counts and history the same on both ranks):
   one y cell a rank (a random 6x2 core), IAEA-2D 2x2 y PERIODIC, IAEA-3D
   1x1x2 z cut under ``NEUTFEM_PARTTRI=0`` (``V18C``).  The scan runs no
   kernel of its own (the JAX package's is XLA, no Pallas kernel): [18]
   adds no kernel row.
19. the literature cores through the port's entry points, each path with
   its own counts: (a) ``validate.validate()`` at float32 (IAEA-2D 8x8,
   BIBLIS, KOEBERG 32x32, ZION 48x48, IAEA-3D 6x6x4), each core within its
   JAX pcm bound of k_ref, within 1e-5 of the JAX package's TPU k and on
   its float32 counts (``VALIDATE_ANCHORS``); K2 / K3 (K1-K3 on IAEA-3D)
   every CG iteration; the cores above
   the two-grid threshold (BIBLIS, KOEBERG, ZION) on the two-grid level
   with K4′ launched, IAEA-2D 8x8 on Jacobi (no coarse level); IAEA-2D's
   assembly power factors within 3% of the published map; (b)
   ``validate.run_ladder`` at ZION 64x64 and 68x68 (1216² and 1292² cells)
   and IAEA-2D 32x32, within 2e-5 of ``PARITY_r05.json``'s k and +-3 of its
   outers (``LADDER_ANCHORS``), K2 / K3 every CG iteration, K4′ launched
   (the (4, 64) tile at ZION); (c) K2 / K3 on ZION 68x68's operands (1, 1,
   1292, 1292) and K4′ at its ``compute_current`` y layout (2, 1, 1, 1293,
   1292) and its line preconditioner's (1, 1, 1292, 1292), each against the
   plain version at the tile the wrapper picks (rows of the JSON line, with
   (b)'s launches; the line row with one line-preconditioned group solve's);
   (d) float64, the card against the CPU through ``runner.run_benchmark``:
   BIBLIS 2x2 and ZION 4x4 with the adjoint (|dk|, |dk_adj| <= 1e-9, the
   same outers, ``Fass`` rel 1e-9).
20. the last entry points of the JAX system, each path with its own counts:
   (a) the scaling ladder ``scaling.main([])`` (IAEA-3D 2x2x2, 4x4x3,
   6x6x4, 8x8x6, 8x8x8, float32 at ``bench.FULL_TOL``), each row on
   ``LADDER_ANCHORS_F32`` (k within 1e-5, 2e-5 from 2.6M cells; outers +-3,
   inners +-15%), K1-K4 launched on every row (K4 at least once a CG
   iteration on 8x8x8's line path, Jacobi below it), with ``per_doubling``, pcm and peak memory printed; (b) the
   ladder at float64 (``--x64``: 2x2x2, 4x4x3, 6x6x4): the first two on the
   JAX package's CPU float64 (``LADDER_ANCHORS_F64``: |dk| <= 1e-9, the same
   outers, inners within 2), 6x6x4 within 2e-5 of (a)'s k, +-3 of its
   outers and inside 2 pcm of k_ref, K1-K4 launched at float64; (c) the
   widest higher-order meshes the JAX package recorded, ``bench.main_ho(1,
   8, 6)`` (RT1-P1, 21.1M flux DOFs a group) and ``main_ho(2, 6, 4)``
   (RT2-P2, 26.7M), on ``WIDE_HO`` (k within 2e-5, outers +-3, from the
   flat flux or one of four start fluxes perturbed by one float32 ulp), K6
   in every direction, K8 on the E-form every CG iteration and K4 launched,
   the inverse-form K8 not at all, the inners, the build seconds and the peak memory
   printed; (d) the kernels at these paths' new shapes, each against its
   plain version with its time (queued behind a sleep), bound and plain
   time and its path's launches (rows of the JSON line): K1-K3 at 4x4x3 and
   8x8x6, K1-K4 at float64 on 6x6x4's operands, K6 z / y / x at RT2-P2
   6x6x4 and RT1-P1 8x8x6 and K8 on RT2-P2 6x6x4's E-form blocks; (e) the
   examples (``neutfem_tpu_torch.examples``: quickstart, convergence_study,
   subcritical_source) at float64 on the card against the CPU (relative
   1e-9; the subcritical example's k 5e-8, the band a 1e-15 start change
   moves it by: ``EXAMPLE_REL_TOL_ROUNDING``), then at their default dtype
   on the card.

``python3 chip_smoke.py --phase 15`` runs [1], [2] and [15] alone and prints
the kernel rows of [15] but no result line; ``--phase 16``, ``--phase 17``,
``--phase 19`` and ``--phase 20`` likewise for [16], [17], [19] and [20];
``--phase 18`` runs [1], [2] and [18] alone.

Every kernel row's bound is the larger of its bytes (each input read once,
each output written once, from the tensors of this run) over 3.35 TB/s and
its floating-point operations over 67 TFLOP/s (the H100 SXM's float32 rate
outside the tensor cores; 34 TFLOP/s, its float64 rate, for [20d]'s float64
rows).  No single PyTorch call computes the functions of
K1-K7, so their rows' ``library_ms`` is null; K8's is the port's former
default block apply on the same stored blocks (``torch.bmm`` on their
float32 copy, then the two dots as ``torch.sum``), timed here and used by
no K8 path.  [3] times each kernel (K1-K8) behind a queued sleep, so that
the host enqueues every launch before the card starts them: its rows
measure device time, not the wrapper's host cost (the tiled kernel takes
~10 µs); they carry ``tile`` and ``share_of_bound``.

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
# must not launch: the one-group x and z directions (and y in mode 2)
EQ_MODES = {"1": (("x_eq_rows", "z_eq_rows"), ("x_rows", "z_rows")),
            "2": (("x_eq2_rows", "y_eq2_rows", "z_eq2_rows"), ("x_rows", "y_rows", "z_rows"))}
# the tiles (lines per block, chunks per line) [3] sweeps the tiled K2 / K3
# kernel over, beside the one fused.rows_tile picks
ROWS_SWEEP = ((2, 32), (4, 32), (8, 32), (16, 32), (8, 16), (16, 16))
ROWS_REPLACES = {"z": "neutfem_tpu/ops/pallas_fused.py:466",
                 "y": "neutfem_tpu/ops/pallas_fused.py:518",
                 "x": "neutfem_tpu/ops/pallas_fused.py:547"}
K5_REPLACES = {"y": "neutfem_tpu/ops/pallas_fused.py:489", "x": "neutfem_tpu/ops/pallas_fused.py:704"}
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
# launch keys of the tiled K6 and K5 kernels and of the one-group tiled K1-K3
HO_KEYS = ("ho_z_rows", "ho_y_rows", "ho_x_rows")
K5_KEYS = ("y_batched_rows", "x_batched_rows")
Z_KEYS = ("z_rows", "y_rows", "x_rows")
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
# [15] anchors of the JAX package on a CPU at float32 (NEUTFEM_X64=0), IAEA-3D
# 3x3x2 RT0-P0 (57x57x38 cells; the 6x6x4 main-path mesh is not run on that
# CPU): (k, outers, inners), from
#   NEUTFEM_X64=0 JAX_PLATFORMS=cpu python -c "from benchmarks.runner import
#   BenchmarkRun; from benchmarks.data import BENCHMARKS; s = BenchmarkRun(
#   BENCHMARKS['iaea3d'], mesh_n=3, mesh_nz=2).solver; s.set_tol(1e-5, 1e-4,
#   1e-4, 200, 1000); print(s.SolveKeff(use_diagonal_solver=True),
#   s._last_outers, s._last_inners)"
# and, for "lumped", power_iteration(s._fes, s._ng, dataclasses.replace(
# s._opts('lumped'), a_mode='lumped'), s._ctx('lumped'), s._flat_phi(), 1.0)
# at the same tolerances
DIAG_ANCHOR = (1.0194131, 34, 374)
LUMPED_ANCHOR = (1.0287660, 34, 303)
# [15e] BiCGSTAB runs at float64: from the flat start flux its float32 dots
# overflow on IAEA-3D (the residual of x0 = 1 / sdi in the 1e15 absorber
# cells reaches |r|^2 ~ 1e22 and <t, t> overflows: omega = inf / inf), in the
# JAX package (k NaN after one inner at 1x1 and at 3x3x2 on a CPU, float32)
# and in the port alike.  Its anchor: the JAX package on a CPU at float64,
# IAEA-3D 3x3x2 at bench.SWEEP_TOL, power_iteration(..., dataclasses.replace(
# s._opts('exact'), inner_solver='bicgstab'), ...): (k, outers, inners)
BICGSTAB_ANCHOR = (1.0287386, 49, 419)
# a variant against the row it is held to: the same fixed point at
# bench.SWEEP_TOL (tol_keff 1e-6) within the float32 band of SCALE_KEFF_TOL
VARIANT_PAIR_TOL = 2e-5
# the bottom face's current against the prescribed q = 1, relative (float32)
NEUMANN_Q_REL = 1e-5
# [19a] neutfem_tpu_torch.validate's five cores: (k, outers, inners).  k is the
# JAX package's TPU float32 k of VALIDATE_r05.json (held within KEFF_TOL); the
# counts are the JAX package's float32 counts at bench.FULL_TOL on a CPU
# (outers +-3, inners +-15%): KOEBERG, ZION and IAEA-3D those of ANCHORS_2D
# and [5], IAEA-2D 8x8 (k 1.0295719 there) and BIBLIS 32x32 (k 1.0251184)
# from
#   NEUTFEM_X64=0 JAX_PLATFORMS=cpu python -c "from benchmarks.runner import
#   BenchmarkRun; from benchmarks.data import BENCHMARKS; r = BenchmarkRun(
#   BENCHMARKS['biblis2d'], mesh_n=32); print(r.solve(), r.solver._last_outers,
#   r.solver._last_inners)"
# (and BENCHMARKS['iaea2d'], mesh_n=8)
VALIDATE_ANCHORS = {"iaea2d": (1.0295748, 34, 1300), "biblis2d": (1.025118, 25, 1670),
                    "koeberg2d": (1.0079671, 34, 3836), "zion2d": (1.274965, 30, 4391),
                    "iaea3d": (1.0291045, 34, 1068)}
# the largest |deviation| of IAEA-2D 8x8's assembly power factors from the
# published map, percent (tests/test_benchmarks.py's bound at 8x8)
POWER_DEV_PCT = 3.0
# [19b] the fine 2D parity ladder's new rows (validate.run_ladder at
# validate.LADDER_TOL): (core, mesh) -> (k, outers) of the JAX package on the
# TPU at float32 (PARITY_r05.json); k within LADDER_KEFF_TOL, outers +-3
LADDER_ANCHORS = {("zion2d", 64): (1.2749408, 38), ("zion2d", 68): (1.2749062, 38),
                  ("iaea2d", 32): (1.0296507, 35)}
LADDER_KEFF_TOL = 2e-5
# the H100 SXM's published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# and float64 outside the tensor cores (the same data sheet)
F64_FLOP_PER_S = 34e12
# floating-point operations per cell of one fused RT0 direction: the face
# rhs (3), the forward elimination (3), the backward sweep (3), the divergence
# update (4)
FUSED_FLOPS_PER_CELL = 13
# per element of a Thomas solve: forward 2, diagonal 1, backward 2
THOMAS_FLOPS_PER_ELEMENT = 5


def _reset_counts():
    """Zero the launch counters and the CG counters (``tracing``'s totals
    under ``bench.LAUNCH_PREFIXES``, and ``cg.*``)."""
    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.bench import LAUNCH_PREFIXES, reset_cg_counts

    tracing.reset_totals([k for k in tracing.totals() if k.partition(".")[0] in LAUNCH_PREFIXES])
    reset_cg_counts()


def _counts():
    """Every launch counter's total under its bare key (``bench.launch_counts``),
    as a ``Counter``: 0 for a kernel never launched, and it pickles from a
    spawned rank."""
    import collections

    from neutfem_tpu_torch.bench import launch_counts

    return collections.Counter(launch_counts())


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


def _bound(tensors, flops, flop_rate=F32_FLOP_PER_S):
    """(bound ms, "bytes" | "operations"): the least time for reading every
    input once and writing every output once (``tensors``, outputs listed as
    often as they are written) or for ``flops`` operations at ``flop_rate``
    (float32 by default)."""
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _row(name, source, replaces, key, err, ms, plain_ms, bound, library_ms=None):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "key": key,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _compare(name, got, want, base, tol=KERNEL_REL_TOL):
    """max |got - want| and its size relative to the contribution want - base."""
    import torch

    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want - base)))
    rel = err / scale if scale > 0 else err
    print(f"  {name}: max_abs_err {err:.3e}  rel {rel:.3e}")
    if not rel <= tol:
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


def _wide_case(label, r, d, l, card, sweep=True):
    """K4′ at one wide layout (a solve along axis -2, ``thomas.wide_rows``):
    the wrapper, which launches the tiled kernel of csrc/thomas_wide_rows.cu
    at the tile ``thomas.wide_tile`` picks, against the plain version and
    timed queued behind a sleep; then, with ``sweep``, the tiled kernel at
    the tiles of ``WIDE_SWEEP``.  Returns a row."""
    import torch

    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.ops import thomas

    n, inner = r.shape[-2], r.shape[-1]
    lines = r.numel() // n
    if not thomas.wide_rows(r.shape, -2):
        raise RuntimeError(f"K4′ {label}: {tuple(r.shape)} is not the wide layout")
    want = thomas.thomas_solve_plain(r, d, l, -2)
    before = tracing.total("thomas.thomas_wide_rows")
    got = thomas.thomas_solve(r, d, l, -2)
    torch.cuda.synchronize()
    if tracing.total("thomas.thomas_wide_rows") != before + 1:
        raise RuntimeError(f"K4′ {label}: the wrapper did not launch the tiled kernel")
    zero = torch.zeros_like(want)
    err = _compare(f"K4′ tiled {label}", got, want, zero)
    ms, t = _kernel_ms(lambda: thomas.thomas_solve(r, d, l, -2))
    plain_ms = _timed(lambda: thomas.thomas_solve_plain(r, d, l, -2), 3)
    bound = _bound((r, d, l, got), THOMAS_FLOPS_PER_ELEMENT * r.numel())
    tile = thomas.wide_tile(n, lines // inner, inner,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    sweep = _tile_sweep(f"K4′ tiled {label}", WIDE_SWEEP if sweep else (),
                        lambda _, tile: thomas.thomas_solve(r, d, l, -2, tile), want, zero, zero)
    print(f"  K4′ {label} {tuple(r.shape)}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms "
          f"({t[0]:.4f}, {t[1]:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} "
          f"lines of {n}; share of bound {bound[0] / ms:.3f}; {card})")
    if sweep:
        print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K4′ Thomas solve for few, long lines (_solve_y), {label}",
               "neutfem_tpu_torch/csrc/thomas_wide_rows.cu",
               "neutfem_tpu/ops/pallas_tridiag.py:197", "thomas_wide_rows", err, ms, plain_ms,
               bound)
    row.update(tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
    return row


def _thomas_rows_case(label, r, d, l, axis, replaces, card):
    """K4 at one layout: the wrapper, which launches the tiled kernel at the
    tile ``thomas.thomas_tile`` picks, against the plain version and timed
    queued behind a sleep; then the tiled kernel at the tiles of
    ``Z_SWEEP``.  Returns a row."""
    import math

    import torch

    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.ops import thomas

    axis %= r.ndim
    n = r.shape[axis]
    inner = math.prod(r.shape[axis + 1:])
    lines = r.numel() // n
    want = thomas.thomas_solve_plain(r, d, l, axis)
    before = tracing.total("thomas.thomas_rows")
    got = thomas.thomas_solve(r, d, l, axis)
    torch.cuda.synchronize()
    if tracing.total("thomas.thomas_rows") != before + 1:
        raise RuntimeError(f"K4 {label}: the wrapper did not launch the tiled kernel")
    zero = torch.zeros_like(want)
    err = _compare(f"K4 tiled {label}", got, want, zero)
    ms, t = _kernel_ms(lambda: thomas.thomas_solve(r, d, l, axis))
    plain_ms = _timed(lambda: thomas.thomas_solve_plain(r, d, l, axis), 3)
    bound = _bound((r, d, l, got), THOMAS_FLOPS_PER_ELEMENT * r.numel())
    tile = thomas.thomas_tile(n, r.dtype, inner == 1)
    sweep = _tile_sweep(f"K4 tiled {label}", Z_SWEEP,
                        lambda _, tile: thomas.thomas_solve(r, d, l, axis, tile), want, zero, zero)
    print(f"  K4 {label} {tuple(r.shape)} axis {axis - r.ndim}: tiled kernel (tile "
          f"{tile[0]}x{tile[1]}) {ms:.4f} ms ({t[0]:.4f}, {t[1]:.4f}), plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({lines} lines of {n}; {card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K4 batched Thomas solve, {label}", "neutfem_tpu_torch/csrc/thomas_rows.cu",
               replaces, "thomas_rows", err, ms, plain_ms, bound)
    row.update(tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
    return row


def _kernel_ms(fn, reps=50):
    """Device ms of ``fn``, timed twice, each queued behind a sleep: (the
    mean, the two readings)."""
    t = [_timed(fn, reps, queued=True) for _ in range(2)]
    return sum(t) / 2, t


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


def _rows_case(kid, key, ctxg, di, v, acc0, card, label, sweep=True):
    """K1 (z), K2 (y) or K3 (x) on one group's flux: the wrapper, which
    launches the tiled kernel at the tile ``fused.z_tile`` (z) or
    ``fused.rows_tile`` picks, against the plain version on the NATURAL
    operands and timed queued behind a sleep; then, with ``sweep``, the
    tiled kernel at the tiles of ``Z_SWEEP`` (z) or ``ROWS_SWEEP``.  Returns
    a row."""
    import torch

    from neutfem_tpu_torch import tracing
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
    before = tracing.total(f"fused.{key}_rows")
    got = wrapper(acc0.clone(), v, dm, ll, *c)
    torch.cuda.synchronize()
    if tracing.total(f"fused.{key}_rows") != before + 1:
        raise RuntimeError(f"{kid} {label}: the wrapper did not launch the tiled kernel")
    err = _compare(f"{kid} tiled {key} {label}", got, want, acc0)
    scratch = acc0.clone()
    ms, t = _kernel_ms(lambda: wrapper(scratch, v, dm, ll, *c))
    plain_ms = _timed(lambda: fused.fused_dir_plain(acc0, v, *nat, axis, *c), 3)
    bound = _bound((v, acc0, got, dm, ll), FUSED_FLOPS_PER_CELL * v.numel())
    tile = (fused.z_tile if key == "z" else fused.rows_tile)(lines, n, v.dtype)
    sweep = _tile_sweep(f"{kid} tiled {key} {label}",
                        (Z_SWEEP if key == "z" else ROWS_SWEEP) if sweep else (), tiled, want,
                        acc0, scratch)
    print(f"  {kid} {key} {label}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms "
          f"({t[0]:.4f}, {t[1]:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} "
          f"lines of {n} cells; share of bound {bound[0] / ms:.3f}; {card})")
    if sweep:
        print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    source = "fused_z_rows.cu" if key == "z" else "fused_rows.cu"
    row = _row(f"{kid} fused Schur direction {key}{label}", f"neutfem_tpu_torch/csrc/{source}",
               ROWS_REPLACES[key], f"{key}_rows", err, ms, plain_ms, bound)
    row.update(tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
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
    whole context, against the plain version on the natural ones;
    ``timed``: timed queued behind a sleep, and the tiled kernel swept over
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

    def tiled(acc, tile, rows=key != "z"):
        ptrs = (acc.data_ptr(), v.data_ptr(), dm.data_ptr(), ll.data_ptr())
        if rows:
            err = lib.neutfem_fused_rows_batched_f32(*ptrs, n, lines, ng, *strides, gs,
                                                     int(strides[2] == 1), *tile, *c, stream)
        else:
            err = lib.neutfem_fused_z_rows_f32(*ptrs, n, lines, ng, *tile, *c, stream)
        cuda_lib.check(err, "fused_rows_batched")
        return acc

    tile = (fused.z_tile if key == "z" else fused.rows_tile)(lines, n, v.dtype)
    extra = {"tile": list(tile)}
    if timed:
        ms, _ = _kernel_ms(lambda: wrapper(scratch, v, dm, ll, *c))
        sweep = _tile_sweep(f"{kid} {key} {label}", Z_SWEEP if key == "z" else ROWS_SWEEP,
                            tiled, want, acc0, scratch)
        extra.update(share_of_bound=bound[0] / ms, sweep=sweep)
        if key == "z":
            extra["rows_form_sweep"] = _rows_form_sweep(
                f"{kid} {key} {label}", lambda a, tile: tiled(a, tile, True), want, acc0, scratch)
    else:
        ms = _timed(lambda: wrapper(scratch, v, dm, ll, *c), 3)
    plain_ms = _timed(lambda: fused.fused_dir_plain(acc0, v, *nat, axis, *c), 3)
    print(f"  {kid} {key} {label} {tuple(v.shape)}: kernel {ms:.4f} ms  plain "
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
    on the staged operands against ``fused_eq_plain`` on the natural ones
    and timed queued behind a sleep; then the tiled kernel at the tiles of
    ``Z_SWEEP`` (z) or ``ROWS_SWEEP``.  Returns a row."""
    import torch

    from neutfem_tpu_torch import tracing
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
    u_buf = torch.empty_like(y)
    ce_ptr = ce.data_ptr() if key.startswith("x") else None

    def call(acc):
        if key.startswith("x"):
            return wrapper(y, sdi, ce, dm, ll, *c)
        if key == "z_eq":
            return wrapper(acc, y, dm, ll, sdi, *c)
        return wrapper(acc, y, sdi, dm, ll, *c)

    def tiled(acc, tile):
        """the tiled kernel at ``tile`` through the library: the output (a
        new tensor for the x variants, as the wrapper)"""
        out = torch.empty_like(y) if key.startswith("x") else acc
        cuda_lib.check(lib.neutfem_fused_eq_rows_f32(
            flags, out.data_ptr(), y.data_ptr(), sdi.data_ptr(), ce_ptr, dm.data_ptr(),
            ll.data_ptr(), u_buf.data_ptr(), n, lines, *strides, *tile, *c, stream), key)
        return out

    before = tracing.total(f"fused_eq.{key}_rows")
    got = call(acc0.clone())
    got, got_u = got if key == "x_eq" else (got, None)
    if tracing.total(f"fused_eq.{key}_rows") != before + 1:
        raise RuntimeError(f"K7 {key}: the wrapper did not launch the tiled kernel")
    want, want_u = fused_eq.fused_eq_plain(key, acc0, y, sdi, ce, *nat, axis, *c)
    torch.cuda.synchronize()
    base = ce * y if key.startswith("x") else (sdi * acc0 if key.startswith("z") else acc0)
    err = _compare(f"K7 tiled {key}", got, want, base)
    if got_u is not None and not torch.equal(got_u, want_u):
        raise RuntimeError("K7 x_eq: u differs from sdi*y")
    scratch = acc0.clone()
    ms, t = _kernel_ms(lambda: call(scratch))
    plain_ms = _timed(lambda: fused_eq.fused_eq_plain(key, acc0, y, sdi, ce, *nat, axis, *c), 3)
    reads = [y, sdi, dm, ll] + ([ce] if key.startswith("x") else [acc0])
    writes = [got] + ([got_u] if got_u is not None else [])
    # per cell: the fused direction, plus u = sdi*y (1), ce*y + (2), sdi*( ) (1)
    extra = {"x_eq": 3, "z_eq": 1, "x_eq2": 3, "y_eq2": 1, "z_eq2": 2}[key]
    bound = _bound(reads + writes, (FUSED_FLOPS_PER_CELL + extra) * y.numel())
    tile = fused_eq.eq_tile(axis, lines, n, y.dtype)
    sweep = _tile_sweep(f"K7 tiled {key}", Z_SWEEP if dkey == "z" else ROWS_SWEEP, tiled, want,
                        acc0, scratch, base)
    print(f"  K7 {key}: tiled kernel (tile {tile[0]}x{tile[1]}) {ms:.4f} ms ({t[0]:.4f}, "
          f"{t[1]:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({lines} lines of {n} "
          f"cells per launch; {card})")
    print(f"    tiles (lines x chunks: ms): {'; '.join(sweep)}")
    row = _row(f"K7 equilibration-folded Schur direction {key} (6x6x4)",
               "neutfem_tpu_torch/csrc/fused_eq_rows.cu", replaces, f"{key}_rows", err, ms,
               plain_ms, bound)
    row.update(tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
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
    tiled kernel) held to the plain version and timed queued behind a sleep;
    then the tiled kernel at the tiles of ``_k8_tiles``.
    library_ms is the port's previous default apply on the same stored
    blocks (``power._block_precond``: torch.bmm on their float32 copy) plus
    the two dots.  Returns the rows, E-form first."""
    import torch

    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.ops import blockjac
    from neutfem_tpu_torch.power import _block_precond

    P = fes.P
    dev = ctxg["C"].device
    eform = ctxg["precond_blk_dev"]
    eye = torch.eye(P, device=dev).reshape(P, P, 1, 1, 1)
    bi = (eform.float() + eye).bfloat16().contiguous()
    r = torch.as_tensor(rng.standard_normal((P, *fes.mesh.shape)), dtype=torch.float32,
                        device=dev)
    cells = r.numel() // P

    def dots_agree(name, got, want):
        for what, g, w in (("<r,z>", got[1], want[1]), ("<r,r>", got[2], want[2])):
            rel = abs(float(g) - float(w)) / abs(float(w))
            print(f"  {name} {what}: {float(g):.7e} vs {float(w):.7e} (rel {rel:.2e})")
            if not rel <= KERNEL_REL_TOL:
                raise RuntimeError(f"{name}: {what} disagrees with the plain version")

    rows = []
    for form, blk, wrapper, key, deviation in (
            ("E-form", eform, blockjac.blockjac_dev_dots, "blockjac_dev", True),
            ("bf16", bi, blockjac.blockjac_dots, "blockjac_tiled", False)):
        name = f"K8 RT{order}-P{order} {form}"
        before = tracing.total(f"blockjac.{key}")
        got = wrapper(blk, r)
        plain = blockjac.blockjac_dots_plain(blk, r, deviation)
        torch.cuda.synchronize()
        if tracing.total(f"blockjac.{key}") != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch the tiled kernel")
        base = r if deviation else torch.zeros_like(r)  # z - base: the blocks' contribution
        err = _compare(f"{name} z", got[0], plain[0], base)
        dots_agree(name, got, plain)
        ms, t = _kernel_ms(lambda: wrapper(blk, r))
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
              f"({t[0]:.4f}, {t[1]:.4f}), plain {plain_ms:.4f} ms, library (bmm on the float32 "
              f"copy + 2 dots) {library_ms:.4f} ms, bound {bound[0]:.4f} ms ({card})")
        print(f"    tiles (wide x warps: ms): {'; '.join(sweep)}")
        path = "phase [6]'s RT path" if deviation else "phase [12]'s RT1-P1 BLOCKJAC path"
        row = _row(f"K8 block-Jacobi apply + dots (RT{order}-P{order} 4x4x2, {form} blocks; "
                   f"launches: {path})", "neutfem_tpu_torch/csrc/blockjac_tiled.cu",
                   "neutfem_tpu/ops/pallas_blockjac.py:114", key, err, ms, plain_ms, bound,
                   library_ms)
        row.update(tile=list(tile), share_of_bound=bound[0] / ms, sweep=sweep)
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


#: The CG step's vector lengths (one group's flux, numel) at the benchmark's
#: four cells, and whether the step writes r * r there (not under K8's dots).
CG_STEP_SHAPES = (("IAEA-3D 6x6x4", 987_696, True), ("ZION 48x48", 831_744, True),
                  ("IAEA-3D 8x8x8", 3_511_808, True), ("RT2-P2 4x4x2", 27 * 219_488, False))


def _cg_step_case(label, n, rr, card, rng):
    """The CG step's two kernels (``ops/cgstep``: cg_xr then cg_p) against
    their plain versions at one vector length, float32: bit for bit, then
    both timed queued; the plain pair is the ATen step they replaced less
    its dots."""
    import torch

    from neutfem_tpu_torch.ops import cgstep

    dev = torch.device("cuda")
    x, r, p, q, z = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
                     for _ in range(5))
    s = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=dev)
    pq, rz, rz1, rr1, rr0 = (s(v) for v in rng.uniform(0.5, 2.0, 5))
    it, go, tol_sq = s(3, torch.int32), s(True, torch.bool), s(1e-12)

    def pair(xr, pp):
        out = xr(x, r, p, q, pq, rz, go, rr=rr)
        return (*out, *pp(z, p, pq, rz, rz1, rr1, rr0, it, go, tol_sq, 1000))

    got, want = pair(cgstep.cg_xr, cgstep.cg_p), pair(cgstep.cg_xr_plain, cgstep.cg_p_plain)
    torch.cuda.synchronize()
    if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError(f"CG step {label}: the kernels differ from the plain versions")
    ms = _timed(lambda: pair(cgstep.cg_xr, cgstep.cg_p), 50, queued=True)
    plain_ms = _timed(lambda: pair(cgstep.cg_xr_plain, cgstep.cg_p_plain), 50, queued=True)
    # cg_xr reads x, r, p, q, writes x, r (and r * r); cg_p reads z, p, writes p
    bound = _bound([x, r, p, q, x, r, *([r] if rr else []), z, p, p], 0)
    row = _row(f"CG step {label} (n {n})", "neutfem_tpu_torch/csrc/cg_step.cu",
               "none (the JAX step is one XLA fusion)", "cg_xr", 0.0, ms, plain_ms, bound)
    print(f"    {row['name']}: bit for bit; kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({card})")
    return row


def _ho_kernels(bench, order, card, rng):
    """K6 z / y / x against fused_ho_plain on the IAEA-3D 4x4x2 RT_k-P_k operands
    (group 0, float32): the wrapper, which launches the tiled kernel at the
    tile ``fused_ho.ho_tile`` picks, held to the plain version and timed
    queued behind a sleep; then the tiled kernel at the tiles of
    ``HO_SWEEP``.  The plain version reads the NATURAL operands and takes
    its mode grouping from the FE space's p -> t map; the kernels read the
    staged ones and compute their own mode index.  Returns the rows and K8's."""
    import torch

    from neutfem_tpu_torch import tracing
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.ops import cuda_lib, fused_ho
    from neutfem_tpu_torch.power import ctx_group

    spec = BENCHMARKS["iaea3d"]
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
        ptrs = tuple(o.data_ptr() for o in ops)

        def tiled(acc, tile):
            cuda_lib.check(lib.neutfem_fused_ho_rows_f32(
                acc.data_ptr(), v.data_ptr(), *ptrs, tab.data_ptr(), k1, 2 - axis, n, lines,
                *strides, nz * ny * nx, *tile, stream), "fused_ho_rows")
            return acc

        before = tracing.total(f"fused_ho.ho_{key}_rows")
        got = wrapper(acc0.clone(), v, *ops, tabs)
        want = fused_ho.fused_ho_plain(acc0, v, *natural, axis - 3, tabs)
        torch.cuda.synchronize()
        if tracing.total(f"fused_ho.ho_{key}_rows") != before + 1:
            raise RuntimeError(f"K6 RT{order} {key}: the wrapper did not launch the tiled kernel")
        err = _compare(f"K6 RT{order} tiled {key}", got, want, acc0)
        scratch = acc0.clone()
        ms, t = _kernel_ms(lambda: wrapper(scratch, v, *ops, tabs))
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
              f"{ms:.4f} ms ({t[0]:.4f}, {t[1]:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({lines} lines of {n} cells; {card})")
        print(f"    tiles (lines x chunks x modes: ms): {'; '.join(sweep)}")
        rows[key] = _row(f"K6 condensed Schur direction {key} (RT{order}-P{order})",
                         "neutfem_tpu_torch/csrc/fused_ho_rows.cu", HO_REPLACES[key],
                         f"ho_{key}_rows", err, ms, plain_ms, bound)
        rows[key].update(tile=list(tile), share_of_bound=bound[0] / ms)
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

    from neutfem_tpu_torch.data import BENCHMARKS

    r = bench.BenchmarkRun(BENCHMARKS["koeberg2d"], mesh_n=4,
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
    from neutfem_tpu_torch.power import ctx_group, group_plan, group_solve

    fes, ctx = s._fes, s._ctx
    ctx.setdefault(krylov.CG_PLANS, krylov.CGPlans())
    ctxg = ctx if g is None else ctx_group(ctx, g)
    rhs = _fission_rhs(s, g)
    x0 = torch.zeros_like(rhs)
    with bench.env(**(switches or {})):
        group_solve(fes, ctxg, opts, rhs, x0)  # the plan and its capture
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        got = group_solve(fes, ctxg, opts, rhs, x0)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
        cg = bench.cg_counts()
        c1 = _counts()
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
        c2 = _counts()
    graph_l = {k: v for k, v in c1.items() if v}
    eager_l = {k: c2[k] - c1[k] for k in c1 | c2 if c2[k] != c1[k]}
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

    from neutfem_tpu_torch import data
    from neutfem_tpu_torch.rounding_probe import perturbed_start

    f32, f64 = torch.float32, torch.float64

    def k14(launches, what):
        """The K1-K4 launches of a path (all of them > 0)."""
        got = {k: launches.get(k, 0) for k in (*Z_KEYS, "thomas_rows")}
        if min(got.values()) <= 0:
            raise RuntimeError(f"{what}: K1-K4 launches {got}")
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


def _cyclic_rhs(fes, ctxg, di, v):
    """The folded face rhs rc of a PERIODIC direction (``apply.solve_A_dir``'s
    cyclic branch) from a flux ``v`` of one group, with the factors and the
    axis K4 / K4′ solve it along: (rc, dinv, l, axis)."""
    import torch

    from neutfem_tpu_torch.ops.apply import apply_BT_dir

    key = f"d{di.d}"
    rF, _ = apply_BT_dir(fes, di, v)
    rFs = rF / float(di.m_t[0])
    ax = (di.axis - 3) % rFs.ndim
    n1 = rFs.shape[ax]
    rc = torch.cat([rFs.narrow(ax, 0, 1) + rFs.narrow(ax, n1 - 1, 1),
                    rFs.narrow(ax, 1, n1 - 2)], dim=ax)
    d = ctxg[f"tri_dinv_{key}"].unsqueeze(-4).expand(rc.shape).contiguous()
    lsh = list(rc.shape)
    lsh[ax] -= 1
    lf = ctxg[f"tri_l_{key}"].unsqueeze(-4).expand(lsh).contiguous()
    return rc, d, lf, ax


def _wielandt_small(device):
    """CMFD "wielandt" at float64 on a random 2-group 2D problem of 4x5 cells
    with both y faces PERIODIC (the case of tests/test_torch_bicgstab.py, where
    the low-order eigensolve converges; on IAEA-3D it walks off, in the JAX
    package too, and two roundings part within a few outers): (k, outers,
    flux on the host)."""
    import numpy as np
    import torch

    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu_torch.ops.context import build_context
    from neutfem_tpu_torch.power import SolveOptions, power_iteration

    rng = np.random.default_rng(4)
    shape = (1, 4, 5)
    mesh = CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (5, 4)])
    fes = make_fespace(mesh, 0, 0)
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(2):
        for up in (False, True):
            bcs.set(boundary_attribute(2, ax, up), BCKind.PERIODIC if ax == 1 else BCKind.DIRICHLET)
    ctx = build_context(fes, 2, xs, bcs, device, torch.float64)
    opts = SolveOptions(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=60,
                        accel="none", use_cmfd=True, cmfd_mode="wielandt", cmfd_lo_outers=20)
    r = power_iteration(fes, 2, opts, ctx, torch.ones((2, *shape, 1), dtype=torch.float64,
                                                      device=device), 1.0)
    return float(r["keff"]), r["outer_iterations"], r["phi"].cpu()


def _variant_paths(bench, dev, card, reset_counts, counts, rows):
    """Phase [15]: the solver features outside the main path on the card
    (``bench.main_variants``; module docstring).  Adds the K4 rows at the
    periodic fold shapes and the K4′ row at KOEBERG 32's to ``rows``."""
    import numpy as np
    import torch

    from neutfem_tpu_torch import data
    from neutfem_tpu_torch.compat import BCType
    from neutfem_tpu_torch.power import ctx_group

    f32, f64 = torch.float32, torch.float64
    one_group = (*Z_KEYS, "thomas_rows", "thomas_wide_rows")

    def variants(names, **kw):
        reset_counts()
        out = {r["row"]: r for r in bench.main_variants(names, device=dev, **kw)}
        for r in out.values():
            d = r["detail"]
            print(f"    {r['row']} ({d['mesh']}, {d['dtype']}): "
                  f"{'M' if r['row'] == 'neumann' else 'keff'} "
                  f"{d.get('keff', d.get('amplification'))!r}, {d['outer_iterations']} / "
                  f"{d['inner_iterations']}, {d['ms_per_outer']:.3f} ms/outer, host reads "
                  f"{d['cg']['host_reads_per_iteration']} per CG iteration ({card})")
            print(f"      launches {d['launches']}")
        return out

    def held(what, got, anchor, keff_tol=KEFF_TOL):
        d = got["detail"]
        print(f"    {what}: ({d['keff']:.7f}, {d['outer_iterations']}, {d['inner_iterations']}) "
              f"against {anchor}")
        _check_anchor(what, d["keff"], d["outer_iterations"], d["inner_iterations"], anchor,
                      keff_tol)

    def pair(what, a, b):
        ka, kb = a["detail"]["keff"], b["detail"]["keff"]
        print(f"    {what}: keff {ka:.8f} against {kb:.8f}, dk {ka - kb:+.2e}")
        if not abs(ka - kb) <= VARIANT_PAIR_TOL:
            raise RuntimeError(f"{what}: keff {ka} not within {VARIANT_PAIR_TOL} of {kb}")

    # (a) the diagonal and lumped A-solves: no TPU kernel, in the JAX package too
    t0 = time.perf_counter()
    print("[15a] diagonal A-solves: neutfem_tpu_torch.bench.main_variants(), IAEA-3D, float32")
    got = variants(("diag", "lumped", "diag_elementwise"))
    for name, r in got.items():
        launched = {k: r["detail"]["launches"].get(k, 0) for k in one_group}
        if any(launched.values()) or r["detail"]["launches"].get("z_batched_rows", 0):
            raise RuntimeError(f"{name}: K1-K4 launched on a diagonal A-solve: {launched}")
        if not np.isfinite(r["detail"]["keff"]):
            raise RuntimeError(f"{name}: keff {r['detail']['keff']}")
    ew = got["diag_elementwise"]["detail"]
    if ew["inner_iterations"] != 0 or not any("diag_elementwise" in w for w in ew["warnings"]):
        raise RuntimeError(f"diag_elementwise: {ew['inner_iterations']} inners, warnings "
                           f"{ew['warnings']}")
    if not 0.5 <= got["diag"]["detail"]["keff"] <= 2.0:
        raise RuntimeError("diag: implausible keff")
    got3 = variants(("diag", "lumped"), mesh=(3, 2), warmup=False)
    held("diag 3x3x2", got3["diag"], DIAG_ANCHOR)
    held("lumped 3x3x2", got3["lumped"], LUMPED_ANCHOR)
    print(f"    [15a] {time.perf_counter() - t0:.1f} s")

    # (b, c) PERIODIC lateral faces against the mirrored quadrant
    t0 = time.perf_counter()
    print("[15b] PERIODIC lateral faces, RT0-P0 6x6x4, against the quadrant (quart_so) with "
          "MIRROR lateral faces, float32")
    got = variants(("periodic", "periodic_mirror"))
    pair("periodic 6x6x4 / quadrant", got["periodic"], got["periodic_mirror"])
    per = got["periodic"]["detail"]
    its = per["cg"]["iterations"]
    if (per["launches"].get("thomas_rows", 0) < 2 * its or per["launches"].get("z_rows", 0) < its
            or per["launches"].get("y_rows", 0) or per["launches"].get("x_rows", 0)):
        raise RuntimeError(f"periodic 6x6x4: launches {per['launches']} for {its} CG iterations")
    k4_periodic = per["launches"]["thomas_rows"]
    print(f"    [15b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("[15c] PERIODIC lateral faces, RT1-P1 4x4x2, against its quadrant, float32")
    got = variants(("periodic_rt1", "periodic_rt1_mirror"), warmup=False)
    pair("periodic RT1-P1 4x4x2 / quadrant", got["periodic_rt1"], got["periodic_rt1_mirror"])
    per = got["periodic_rt1"]["detail"]
    its = per["cg"]["iterations"]
    if (per["launches"].get("thomas_rows", 0) < 2 * its or per["launches"].get("ho_z_rows", 0) <= 0
            or per["launches"].get("ho_y_rows", 0) or per["launches"].get("ho_x_rows", 0)):
        raise RuntimeError(f"periodic RT1-P1: launches {per['launches']} for {its} CG iterations")
    print(f"    [15c] {time.perf_counter() - t0:.1f} s")

    # (d) a subcritical solve driven by a NEUMANN inward current
    t0 = time.perf_counter()
    print("[15d] NEUMANN q = 1 on the bottom face, nu-Sigma_f x 0.9, no volume source: "
          "SolveSubcritical, IAEA-3D 6x6x4, float32 and float64")
    m = {}
    for dt in (f32, f64):
        r = variants(("neumann",), dtype=dt, warmup=dt == f32)["neumann"]["detail"]
        m[dt] = r["amplification"]
        qrel = max(abs(r["bottom_current_min"] - 1.0), abs(r["bottom_current_max"] - 1.0))
        print(f"    {dt}: bottom-face current in [{r['bottom_current_min']!r}, "
              f"{r['bottom_current_max']!r}] (q = 1, rel {qrel:.2e})")
        if not qrel <= NEUMANN_Q_REL:
            raise RuntimeError(f"NEUMANN {dt}: the bottom current is not q")
        if min(r["launches"].get(k, 0) for k in (*Z_KEYS, "thomas_rows")) <= 0:
            raise RuntimeError(f"NEUMANN {dt}: K1-K4 not launched")
    rel = abs(m[f32] - m[f64]) / m[f64]
    print(f"    M float32 {m[f32]!r}, float64 {m[f64]!r}, rel {rel:.2e}")
    if not (np.isfinite(m[f32]) and rel <= SUBCRIT_M_REL):
        raise RuntimeError(f"NEUMANN: float32 M {m[f32]} not within {SUBCRIT_M_REL} of {m[f64]}")
    print(f"    [15d] {time.perf_counter() - t0:.1f} s")

    # (e) BiCGSTAB against the CG, float64 (the float32 run overflows, as in
    # the JAX package: BICGSTAB_ANCHOR's comment), and the float32 rows printed
    t0 = time.perf_counter()
    print("[15e] BiCGSTAB inner solver, IAEA-3D 6x6x4 at bench.SWEEP_TOL, against the CG, "
          "float64")
    got = variants(("bicgstab", "cg"), dtype=f64)
    pair("bicgstab / cg 6x6x4", got["bicgstab"], got["cg"])
    st = got["bicgstab"]["detail"]
    its = st["cg"]["iterations"]
    if (min(st["launches"].get(k, 0) for k in Z_KEYS) < 2 * its or st["cg"]["replays"] <= 0
            or st["cg"]["host_reads_per_iteration"] > 0.3):
        raise RuntimeError(f"bicgstab: launches {st['launches']}, CG {st['cg']}")
    got3 = variants(("bicgstab",), mesh=(3, 2), dtype=f64, warmup=False)
    held("bicgstab 3x3x2 float64", got3["bicgstab"], BICGSTAB_ANCHOR)
    variants(("bicgstab", "wielandt"), dtype=f32, warmup=False)
    print("    (printed, not held: float32 BiCGSTAB overflows from the flat flux; CMFD "
          "\"wielandt\" is experimental in the JAX package)")
    print(f"    [15e] {time.perf_counter() - t0:.1f} s")

    # (f) the card against the CPU at float64 on IAEA-3D 1x1, every feature
    t0 = time.perf_counter()
    print("[15f] IAEA-3D 1x1 float64 (CMFD \"wielandt\": a 4x5 2D problem), card against CPU")
    spec = data.BENCHMARKS["iaea3d"]
    for row in ("diag", "lumped", "periodic", "neumann", "bicgstab", "wielandt"):
        res = {}
        for device in ("cpu", "cuda"):
            if row == "wielandt":
                res[device] = _wielandt_small(torch.device(device))
                continue
            _, s, solve = bench._variant_setup(row, spec, (1, 1), (1, 1), torch.device(device),
                                               f64)
            v, outers, _, _ = solve()
            res[device] = (v, outers, s._phi.cpu())
        (vc, oc, pc), (vg, og, pg) = res["cpu"], res["cuda"]
        frel = float(torch.max(torch.abs(pg - pc)) / torch.max(torch.abs(pc)))
        what = "M" if row == "neumann" else "keff"
        print(f"    {row}: {what} {vg!r} / {vc!r} ({og} / {oc} outers), flux rel {frel:.2e}")
        if not (abs(vg - vc) <= 1e-9 * max(1.0, abs(vc)) and og == oc and frel <= 1e-9):
            raise RuntimeError(f"IAEA-3D 1x1 {row}: the card disagrees with the CPU")
    res = {}
    per_y = _per_y()
    for device in ("cpu", "cuda"):
        r = bench.BenchmarkRun(data.BENCHMARKS["koeberg2d"], 4, device=device, dtype=f64,
                               bc=per_y)
        k = r.solve(tol=(1e-6, 1e-5, 1e-5, 300, 1000))
        res[device] = (k, r.solver._last_outers)
    print(f"    KOEBERG 4x4 (68x68) y PERIODIC: keff {res['cuda'][0]!r} / {res['cpu'][0]!r} "
          f"({res['cuda'][1]} / {res['cpu'][1]} outers)")
    if not (abs(res["cuda"][0] - res["cpu"][0]) <= 1e-9 and res["cuda"][1] == res["cpu"][1]):
        raise RuntimeError("KOEBERG 4x4 y PERIODIC: the card disagrees with the CPU")
    print(f"    [15f] {time.perf_counter() - t0:.1f} s")

    # (g) a 2D y direction PERIODIC where its cyclic solve takes K4′'s layout:
    # KOEBERG 32 (544x544) against the mirrored half core (moitie_s), float32
    t0 = time.perf_counter()
    print("[15g] KOEBERG 32x32 (544x544) y PERIODIC against the half core (moitie_s) with both "
          "y faces MIRROR, float32")
    ks = {}
    for name, kw in (("periodic", dict(bc=per_y)),
                     ("half", dict(domain="moitie_s",
                                   bc={(1, True): (BCType.MIRROR, 0.0)}))):
        reset_counts()
        r = bench.BenchmarkRun(data.BENCHMARKS["koeberg2d"], 32, device=dev, dtype=f32, **kw)
        t1 = time.perf_counter()
        ks[name] = r.solve(tol=bench.SWEEP_TOL)
        wall = time.perf_counter() - t1
        launches = counts()
        s = r.solver
        print(f"    {name} {s._mesh.shape}: keff {ks[name]:.7f}, {s._last_outers} / "
              f"{s._last_inners}, {wall * 1e3 / max(s._last_outers, 1):.3f} ms/outer, "
              f"preconditioner {s.preconditioner()} ({card})")
        print(f"      launches {launches}")
        if name == "periodic":
            k4w_periodic = launches.get("thomas_wide_rows", 0)
            if k4w_periodic < s._last_inners or launches.get("y_rows", 0):
                raise RuntimeError("KOEBERG 32 y PERIODIC: K4′ not launched every CG "
                                   "iteration, or the fused y kernel ran")
            ctxg = ctx_group(s._context(), 0)
            v = torch.as_tensor(np.random.default_rng(3).standard_normal((1, *s._mesh.shape)),
                                dtype=f32, device=dev)
            di_y = next(di for di in s._fes.dirs if di.d == 1)
            wide = _cyclic_rhs(s._fes, ctxg, di_y, v)
        del r, s
    print(f"    dk {ks['periodic'] - ks['half']:+.2e}")
    if not abs(ks["periodic"] - ks["half"]) <= VARIANT_PAIR_TOL:
        raise RuntimeError("KOEBERG 32: the y-periodic core is off the mirrored half core")
    row = _wide_case("periodic y fold (KOEBERG 32)", *wide[:3], card)
    row.pop("key")
    row["launches"] = k4w_periodic
    rows["K4′ periodic y"] = row
    print(f"    [15g] {time.perf_counter() - t0:.1f} s")

    # K4 at the periodic fold shapes of [15b] (x and y of one group, 6x6x4)
    run = bench.BenchmarkRun(spec, 6, 4, device=dev, dtype=f32,
                             bc={f: (BCType.PERIODIC, 0.0) for f in bench.LATERAL})
    s = run.solver
    ctxg = ctx_group(s._context(), 0)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((1, *s._mesh.shape)),
                        dtype=f32, device=dev)
    for di in s._fes.dirs:
        if di.d == 2:
            continue
        key = "zyx"[di.axis]
        row = _thomas_rows_case(f"periodic {key} fold (IAEA-3D 6x6x4)",
                                *_cyclic_rhs(s._fes, ctxg, di, v), K4_REPLACES[key], card)
        row.pop("key")
        row["launches"] = k4_periodic  # [15b]'s periodic solve, every K4 layout
        rows[f"K4 periodic {key}"] = row
    del run, s

# [16] the multi-device solve: k of a sharded solve against the unsharded one
# (float32, two ranks over gloo on one card: the same iteration, another
# summation order of every dot product), its gathered flux (relative to its
# largest entry), and float64 card against CPU
SHARD_KEFF_TOL, SHARD_FLUX_REL, SHARD_F64_TOL = 2e-5, 1e-4, 1e-9
# the ranks of [16c] / [16d] must answer within this many seconds
RANK_TIMEOUT = 420.0


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _sharded_solve(bench, mesh, ga, case, dev, check=None):
    """One rank's sharded power iteration of ``case`` = (core, mesh_n,
    mesh_nz, rt_order, tol, dtype name) on ``dev``: the facade's problem and
    options (built on the CPU, not on the card), the rank's slab of the host
    context, one solve (captures, warm-up), then a timed solve from the flat
    flux with every count set to 0 just before it and read just after.
    Returns its k, counts, history, launches, CG and transport counts, wall
    and the gathered flux (every rank gathers; numpy); ``check(ctx, fes)``,
    when given, runs after that and its kernel rows come back as "rows"."""
    import torch

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.ops.context import build_host_context

    core, n, nz, order, tol, dt = case
    dtype = getattr(torch, dt)
    run = bench.BenchmarkRun(BENCHMARKS[core], mesh_n=n,
                             mesh_nz=nz, device="cpu", dtype=dtype, rt_order=order)
    s = run.solver
    s.set_tol(*tol)
    fes, ng = s._fes, s._ng
    t0 = time.perf_counter()
    host = build_host_context(fes, ng, s._xs, s._bcs, marshak_d_factor=True)
    ctx = parallel.shard_context(host, mesh, fes, ga, device=dev, dtype=dtype)
    del host, run
    build_s = time.perf_counter() - t0
    phi0 = parallel.shard_state(torch.ones((ng, *fes.mesh.shape, fes.P), dtype=dtype), mesh,
                                ga, device=dev)
    solve, _ = parallel.sharded_power_iteration(fes, ng, s._opts(), mesh, ga)
    solve(ctx, phi0, 1.0)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = solve(ctx, phi0, 1.0)
    keff = float(res["keff"])  # a device -> host read ends the solve
    wall = time.perf_counter() - t0
    launches = _counts()
    cg = bench.cg_counts()
    phi = parallel.gather_state(res["phi"], mesh, ga)
    if not bool(res["finite"]) or not bool(torch.isfinite(phi).all()):
        raise RuntimeError(f"sharded {case}: the flux is not finite")
    return {"keff": keff, "outers": res["outer_iterations"], "inners": res["inner_iterations"],
            "history": res["history"].cpu().numpy(), "launches": launches, "cg": cg,
            "loop": res["sharding"]["cg"], "wall": wall, "build_s": build_s,
            "ms_per_outer": 1e3 * wall / max(res["outer_iterations"], 1),
            "local_shape": tuple(res["phi"].shape),
            "phi": phi.to(torch.float64).cpu().numpy(),
            "rows": {} if check is None else check(ctx, fes)}


def _segment_row(ctx, fes, ga, label, card):
    """K4 at a rank's segment of the cut grid axis ``ga``, as the
    partitioned solve calls it (``ops/parttri.tridiag_solve_partitioned``):
    a random rhs of the path's shape (T transverse modes, the rank's slab
    with its s body faces along the cut) through the rank's own segment
    factors (``tri_part_dinv`` / ``tri_part_l`` of group 0), broadcast over T
    and contiguous; the row without its launches."""
    import numpy as np
    import torch

    from neutfem_tpu_torch.power import ctx_group

    di = next(d for d in fes.dirs if d.axis == ga)
    key, ctxg = f"d{di.d}", ctx_group(ctx, 0)
    modes = (di.BXc if fes.et.nbub else di.BX[:2]).shape[-1]
    dinv = ctxg[f"tri_part_dinv_{key}"].unsqueeze(-4)
    ll = ctxg[f"tri_part_l_{key}"].unsqueeze(-4)
    shape = (modes, *dinv.shape[-3:])
    lshape = list(shape)
    lshape[ga - 3] -= 1
    r = torch.as_tensor(np.random.default_rng(16).standard_normal(shape), dtype=dinv.dtype,
                        device=dinv.device)
    row = _thomas_rows_case(label, r, dinv.expand(shape).contiguous(),
                            ll.expand(lshape).contiguous(), ga - 3, K4_REPLACES["zyx"[ga]], card)
    row.pop("key")
    return row


def _slab_rows(ctx, fes, card):
    """[16c]'s kernels at rank 0's shapes: K4 at its z segment (1, 38, 114,
    114) and K2 / K3 on its slab, with the operands ``shard_context``
    restaged from it (random flux and accumulator of the slab's shape); the
    rows without their launches."""
    import numpy as np
    import torch

    from neutfem_tpu_torch.power import ctx_group

    label = " ([16c] rank 0 slab, IAEA-3D 6x6x4 z cut over 2 ranks)"
    rows = {"K4": _segment_row(ctx, fes, 0, "partitioned segment, z cut" + label[:-1] +
                               ", random rhs)", card)}
    ctxg = ctx_group(ctx, 0)
    dirs = {di.axis: di for di in fes.dirs}
    rng = np.random.default_rng(16)
    shape = (1, *ctxg["C"].shape[-3:])
    v, acc0 = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=ctxg["C"].device) for _ in range(2))
    for kid, key, ga in (("K2", "y", 1), ("K3", "x", 2)):
        rows[kid] = _rows_case(kid, key, ctxg, dirs[ga], v, acc0, card, label)
        rows[kid].pop("key")
    return rows


def _gloo_rank(rank, world, init, args):
    """A rank of [16c] / [16d]: gloo between the processes, the card shared
    (cuda:0), each case a z cut; rank 0 checks [16c]'s kernels at its
    shapes while the other waits.  Returns {case: results}."""
    import torch
    import torch.distributed as dist

    cases, card = args
    torch.cuda.set_device(0)
    from neutfem_tpu_torch import bench, parallel

    mesh = parallel.device_mesh("gloo", init_method=init, rank=rank, world_size=world)
    out = {}
    for name, case in cases.items():
        check = None
        if rank == 0 and name == "6x6x4":
            check = lambda ctx, fes: _slab_rows(ctx, fes, card)  # noqa: E731
        out[name] = _sharded_solve(bench, mesh, 0, case, torch.device("cuda"), check)
        dist.barrier()
        if rank:
            out[name]["phi"] = None
    return out


def _gloo_world(cases, card, world=2):
    """[16c] / [16d]'s ranks, spawned (``parallel.spawn_ranks``): each case's
    per-rank results.  A rank that fails, or the deadline, kills every rank
    and raises."""
    from neutfem_tpu_torch import parallel

    results = parallel.spawn_ranks(_gloo_rank, world, f"tcp://localhost:{_free_port()}",
                                   (cases, card), RANK_TIMEOUT)
    return {name: [results[r][name] for r in range(world)] for name in cases}


def _same_on_ranks(what, per_rank):
    first = per_rank[0]
    for r in per_rank[1:]:
        if (r["keff"] != first["keff"] or (r["outers"], r["inners"]) !=
                (first["outers"], first["inners"]) or not (r["history"] == first["history"]).all()):
            seen = [(x["keff"], x["outers"], x["inners"]) for x in per_rank]
            raise RuntimeError(f"{what}: the ranks disagree: {seen}")


def _flux_rel(got, want):
    import numpy as np

    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cpu_reference(bench, mesh_n, mesh_nz, tol):
    """The unsharded IAEA-3D float64 solve on the CPU: (k, outers, flux)."""
    import torch

    from neutfem_tpu_torch.data import BENCHMARKS

    r = bench.BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=mesh_n,
                           mesh_nz=mesh_nz, device="cpu", dtype=torch.float64)
    k = r.solve(tol=tol)
    return k, r.solver._last_outers, r.solver._phi.numpy()


def _sharded_paths(bench, dev, card, rows):
    """Phase [16]: the multi-device solve (``neutfem_tpu_torch/parallel.py``)
    on the card, each path with its own counts (module docstring).  Adds
    the rows of K4 at each path's segment shape, and of K2 / K3 at [16c]'s
    slab, to ``rows``."""
    import torch
    import torch.distributed as dist

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.data import BENCHMARKS

    f32 = torch.float32
    small_tol = (1e-6, 1e-5, 1e-5, 300, 1000)
    t0 = time.perf_counter()
    # the NCCL world of one in this process; [16c] / [16d]'s gloo ranks are
    # processes of their own
    mesh = parallel.device_mesh("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
    print(f"[16a] world of one over {mesh.backend} ({mesh}): IAEA-3D 6x6x4 RT0-P0, float32, "
          "sharded_power_iteration with a z cut and a y cut")
    run = bench.BenchmarkRun(BENCHMARKS["iaea3d"], mesh_n=6,
                             mesh_nz=4, device=dev, dtype=f32)
    run.solve(tol=bench.FULL_TOL)
    run.solver.reset_flux()
    t1 = time.perf_counter()
    k_flat = run.solver.SolveKeff()
    unsharded_ms = 1e3 * (time.perf_counter() - t1) / max(run.solver._last_outers, 1)
    phi_unsharded = run.solver._phi.to(torch.float64).cpu().numpy()
    print(f"    unsharded: keff {k_flat}, {run.solver._last_outers} / "
          f"{run.solver._last_inners}, {unsharded_ms:.3f} ms/outer ({card})")
    del run
    torch.cuda.empty_cache()
    k1 = 0
    for ga, cut in ((0, "z"), (1, "y")):
        label = f"partitioned segment, {cut} cut (IAEA-3D 6x6x4, world of one, random rhs)"
        got = _sharded_solve(bench, mesh, ga, ("iaea3d", 6, 4, 0, bench.FULL_TOL, "float32"), dev,
                             lambda ctx, fes, ga=ga, label=label: _segment_row(ctx, fes, ga,
                                                                              label, card))
        L = got["launches"]
        print(f"    {cut} cut: keff {got['keff']}, {got['outers']} / {got['inners']}, "
              f"{got['ms_per_outer']:.3f} ms/outer against the unsharded {unsharded_ms:.3f} "
              f"(same call; {card}); context slab built in {got['build_s']:.1f} s")
        comm = {k: L[k] for k in ("collectives", "comm_bytes", "staged_bytes")}
        print(f"      CG: {got['cg']} ({got['loop']}); transport {comm}")
        print(f"      launches {{{', '.join(f'{k}: {v}' for k, v in L.items() if v)}}}; flux rel "
              f"{_flux_rel(got['phi'], phi_unsharded):.2e} of the unsharded")
        _check_anchor(f"sharded 6x6x4 {cut} cut", got["keff"], got["outers"], got["inners"],
                      (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
        if got["loop"] != "graph" or got["cg"]["replays"] < got["cg"]["solves"]:
            raise RuntimeError(f"{cut} cut: the CG did not replay its graphs under NCCL")
        if L["thomas_rows"] < got["inners"]:
            raise RuntimeError(f"{cut} cut: K4 launched {L['thomas_rows']} times for "
                               f"{got['inners']} CG iterations (the segment solve)")
        uncut = {"z": ("y_rows", "x_rows"), "y": ("z_rows", "x_rows")}[cut]
        if any(L[k] < got["inners"] for k in uncut):
            raise RuntimeError(f"{cut} cut: the uncut directions' kernels did not run every CG "
                               "iteration")
        rows[f"K4 segment {cut}"] = dict(got["rows"], launches=L["thomas_rows"])
        k1 += L["z_rows"]
    if not k1:
        raise RuntimeError("[16a]: K1 did not run on the y-cut path")
    print(f"    [16a] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print(f"[16b] world of one over nccl: IAEA-3D 4x4x2 RT1-P1, float32, z cut, on "
          f"main_ho(1)'s anchors {HO_ANCHORS[1]}")
    got = _sharded_solve(bench, mesh, 0, ("iaea3d", 4, 2, 1, bench.HO_TOL, "float32"), dev,
                         lambda ctx, fes: _segment_row(
                             ctx, fes, 0, "partitioned segment, z cut (IAEA-3D 4x4x2 RT1-P1, "
                             "world of one, random rhs)", card))
    L = got["launches"]
    print(f"    keff {got['keff']}, {got['outers']} / {got['inners']}, "
          f"{got['ms_per_outer']:.3f} ms/outer ({card}); CG {got['cg']} ({got['loop']})")
    print(f"    launches {{{', '.join(f'{k}: {v}' for k, v in L.items() if v)}}}")
    _check_anchor("sharded RT1-P1 4x4x2 z cut", got["keff"], got["outers"], got["inners"],
                  HO_ANCHORS[1])
    for key in ("ho_y_rows", "ho_x_rows", "thomas_rows", "blockjac_dev"):
        if L[key] < got["inners"]:
            raise RuntimeError(f"[16b]: {key} launched {L[key]} times for {got['inners']} CG "
                               "iterations")
    if L["ho_z_rows"]:
        raise RuntimeError("[16b]: K6 ran along the cut z")
    rows["K4 segment RT1-P1 z"] = dict(got["rows"], launches=L["thomas_rows"])
    print(f"    [16b] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("[16d] IAEA-3D 1x1 float64, z cut, the world of one over nccl on the card against "
          "the unsharded solve on the CPU")
    k_cpu, o_cpu, phi_cpu = _cpu_reference(bench, 1, 1, small_tol)
    got = _sharded_solve(bench, mesh, 0, ("iaea3d", 1, 1, 0, small_tol, "float64"), dev)
    dk, rel = got["keff"] - k_cpu, _flux_rel(got["phi"], phi_cpu)
    print(f"    keff {got['keff']!r} vs CPU {k_cpu!r} (dk {dk:+.2e}), outers {got['outers']} / "
          f"{o_cpu}, flux rel {rel:.2e}")
    if not (abs(dk) <= SHARD_F64_TOL and got["outers"] == o_cpu and rel <= SHARD_F64_TOL):
        raise RuntimeError("[16d] world of one: the sharded float64 solve disagrees with the CPU")
    dist.destroy_process_group()

    # [16c] and [16d]'s gloo pair: two ranks sharing the card
    k_cpu2, o_cpu2, phi_cpu2 = _cpu_reference(bench, 1, 2, small_tol)
    ranks = _gloo_world({
        "6x6x4": ("iaea3d", 6, 4, 0, bench.FULL_TOL, "float32"),
        "1x1x2 f64": ("iaea3d", 1, 2, 0, small_tol, "float64")}, card)
    print("[16c] two ranks sharing the card over gloo (host-staged, eager CG block loop): "
          "IAEA-3D 6x6x4, z cut, float32")
    per = ranks["6x6x4"]
    _same_on_ranks("[16c]", per)
    got = per[0]
    dk, rel = got["keff"] - k_flat, _flux_rel(got["phi"], phi_unsharded)
    for rank, r in enumerate(per):
        L = r["launches"]
        print(f"    rank {rank}: slab {r['local_shape']}, keff {r['keff']}, {r['outers']} / "
              f"{r['inners']}, {r['ms_per_outer']:.3f} ms/outer TRANSPORT-BOUND (host-staged "
              f"gloo on one card; not a scaling figure), {L['collectives']} collectives, "
              f"{L['comm_bytes']} bytes, {L['staged_bytes']} bytes staged; CG {r['cg']} "
              f"({r['loop']})")
        print(f"      launches {{{', '.join(f'{k}: {v}' for k, v in L.items() if v)}}}")
        if any(L[k] < r["inners"] for k in ("y_rows", "x_rows", "thomas_rows")):
            raise RuntimeError(f"[16c] rank {rank}: K2-K4 did not run every CG iteration")
        cg = r["cg"]
        if r["loop"] != "eager" or cg["eager_solves"] < cg["solves"] or cg["replays"]:
            raise RuntimeError(f"[16c] rank {rank}: the staged transport must run the eager loop")
    print(f"    keff {got['keff']} against the unsharded {k_flat} (dk {dk:+.2e}), flux rel "
          f"{rel:.2e}; K1 not launched: z, its direction, is the cut one ({card})")
    if not (abs(dk) <= SHARD_KEFF_TOL and rel <= SHARD_FLUX_REL):
        raise RuntimeError("[16c]: the two-rank solve disagrees with the unsharded one")
    L = got["launches"]
    for kid, key in (("K4", "thomas_rows"), ("K2", "y_rows"), ("K3", "x_rows")):
        rows[f"{kid} [16c] slab"] = dict(got["rows"][kid], launches=L[key])
    print("[16d] IAEA-3D 1x1x2 float64 (19 cells on every axis of 1x1: no even cut), z cut, two "
          "gloo ranks on the card against the unsharded solve on the CPU")
    per = ranks["1x1x2 f64"]
    _same_on_ranks("[16d]", per)
    got = per[0]
    dk, rel = got["keff"] - k_cpu2, _flux_rel(got["phi"], phi_cpu2)
    print(f"    keff {got['keff']!r} vs CPU {k_cpu2!r} (dk {dk:+.2e}), outers {got['outers']} / "
          f"{o_cpu2}, flux rel {rel:.2e}")
    if not (abs(dk) <= SHARD_F64_TOL and got["outers"] == o_cpu2 and rel <= SHARD_F64_TOL):
        raise RuntimeError("[16d] gloo ranks: the sharded float64 solve disagrees with the CPU")
    print(f"    [16c] + [16d] {time.perf_counter() - t0:.1f} s")


# [17] the solver variants under a sharding scope.  Held: a sharded Jacobi
# sweep against the unsharded one within SWEEP_KEFF_TOL, CMFD and coarse init
# against the Chebyshev k within VARIANT_KEFF_TOL, BiCGSTAB against the CG
# within VARIANT_PAIR_TOL, DIRECT_LLT within DIRECT_KEFF_TOL, the rest on
# their phases' anchors.  The meshes: (a)'s IAEA-3D, its coarse factors, the
# diag / lumped anchors' mesh and DIRECT_LLT's IAEA-2D; (b)'s IAEA-3D and
# IAEA-2D (two ranks: a cut of 38 cells)
V17_MESH, V17_COARSE, V17_SMALL, V17_2D = (6, 4), (3, 3, 4), (3, 2), (3,)
V17B_MESH, V17B_2D = (1, 2), (2,)
V17_TOL = (1e-5, 1e-4, 1e-4, 600, 1000)  # [17b]'s Jacobi sweep: fewer gloo outers


def _v17_run(kind, s, opts, ctx, phi0, dev, dtype, scope=None, factors=None):
    """One solve of a [17] variant on ``ctx`` / ``phi0`` (a rank's slab under
    ``scope`` = (mesh, axis map), or the whole problem): "power"
    (``power_iteration``), "subcritical" (``solve_subcritical`` at k = 1
    from a zero flux, as ``SolveSubcritical`` after ``reset_flux``) or
    "coarse" (``coarse_init`` at ``factors``, then the power iteration from
    its flux and k).  ``s``: the facade that holds the problem.  Returns the
    result dict, "value" its k or M."""
    import contextlib

    from neutfem_tpu_torch.coarse import coarse_init
    from neutfem_tpu_torch.power import power_iteration, solve_subcritical
    from neutfem_tpu_torch.shardctx import sharding_scope

    fes, ng = s._fes, s._ng
    with sharding_scope(*scope) if scope else contextlib.nullcontext():
        if kind == "subcritical":
            res = solve_subcritical(fes, ng, opts, ctx, phi0 * 0.0, keff=1.0)
            return dict(res, value=float(res["amplification"]))
        k0 = 1.0
        if kind == "coarse":
            k_c, phi0 = coarse_init(fes, ng, s._xs, s._bcs, factors, opts, dev, dtype,
                                    marshak_d_factor=True)
            k0 = float(k_c)
        res = power_iteration(fes, ng, opts, ctx, phi0, k0)
    return dict(res, value=float(res["keff"]))


def _v17_timed(kind, s, opts, ctx, phi0, dev, dtype, scope=None, factors=None, warm=True):
    """A [17] variant: one warm-up run of three outers (the CG captures;
    ``warm``), then one timed run from the same start with every count set
    to 0 just before it and read just after.  Returns its value, counts,
    history, launches, CG counts, ms/outer and the result."""
    import dataclasses

    import torch

    from neutfem_tpu_torch.bench import cg_counts

    if warm:
        _v17_run(kind, s, dataclasses.replace(opts, max_outer=3), ctx, phi0, dev, dtype, scope,
                 factors)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = _v17_run(kind, s, opts, ctx, phi0, dev, dtype, scope, factors)
    wall = time.perf_counter() - t0  # the value's host read ended the run
    outers = res["outer_iterations"]
    if not bool(res["finite"]):
        raise RuntimeError(f"[17] {kind}: the flux is not finite")
    return {"value": res["value"], "outers": outers, "inners": res["inner_iterations"],
            "history": res["history"].cpu().numpy() if "history" in res else None,
            "launches": _counts(), "cg": cg_counts(), "ms": 1e3 * wall / max(outers, 1),
            "res": res}


def _v17_facade(bench, core, mesh, bc=None, subcritical=False, tol=None):
    """The facade of ``core`` at ``mesh`` on the CPU at float64 (its context is
    the host context every rank slices), at ``tol`` (``bench.SWEEP_TOL``); with
    ``subcritical`` [14c]'s problem: nu-Sigma_f x 0.9, a unit fast source in
    every fuel cell."""
    import torch

    from neutfem_tpu_torch import data

    kw = {"bc": bc} if bc else {}
    s = bench.BenchmarkRun(data.BENCHMARKS[core], *mesh, device="cpu", dtype=torch.float64,
                           **kw).solver
    if subcritical:
        s.get_NSF()[...] *= 0.9
        s.get_SRC()[0] = (s.get_NSF() > 0).any(axis=0)
        s.BuildMatrices()
    s.set_tol(*(tol or bench.SWEEP_TOL))
    return s


def _v17_host(s, a_mode="exact", extra=None):
    """The host context of facade ``s`` (float64 on the CPU, P == 1), with
    ``extra`` host arrays (the dense Schur factors)."""
    ctx = s._context(a_mode)
    host = {k: v.numpy() for k, v in ctx.items() if hasattr(v, "numpy")}
    host.update(extra or {})
    return host, None


def _v17_dense(s, dev):
    """The dense Schur factors of facade ``s``'s problem (``attach_dense_schur``
    on the whole context, built on ``dev`` at float64), as host arrays."""
    import torch

    from neutfem_tpu_torch.ops.context import context_to_device
    from neutfem_tpu_torch.ops.direct import attach_dense_schur

    whole = context_to_device(*_v17_host(s), s._fes.P, dev, torch.float64)
    attach_dense_schur(s._fes, whole)
    return {k: whole[k].cpu().numpy() for k in ("schur_chol", "schur_sdi")}


def _v17_wielandt_facade():
    """CMFD "wielandt"'s problem for a cut: [15f]'s random 2-group recipe on
    6x4 cells with x PERIODIC (across a y cut) and vacuum y faces, where the
    low-order eigensolve converges; a facade-like holder of (fes, ng, xs,
    bcs, context) on the CPU at float64."""
    import types

    import numpy as np
    import torch

    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu_torch.ops.context import build_context

    rng = np.random.default_rng(4)
    shape = (1, 4, 6)
    mesh = CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (6, 4)])
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(2):
        for up in (False, True):
            bcs.set(boundary_attribute(2, ax, up), BCKind.PERIODIC if ax == 0 else BCKind.DIRICHLET)
    fes = make_fespace(mesh, 0, 0)
    ctx = build_context(fes, 2, xs, bcs, "cpu", torch.float64)
    return types.SimpleNamespace(_fes=fes, _ng=2, _xs=xs, _bcs=bcs,
                                 _context=lambda a_mode="exact": ctx)


#: [17b]'s variants: name -> (problem, run kind, option overrides, a_mode)
V17B = {
    "jacobi": ("1x1x2", "power", dict(sweep="jacobi"), "exact"),
    # IAEA-2D: on IAEA-3D 1x1x2 the first correction does not reproduce to
    # rounding (a 1e-15 change of the start flux moves k at three outers by
    # up to 6.7e-4 on the CPU, unsharded); on IAEA-2D 2x2 by 4e-11
    "cmfd 3 outers": ("iaea2d 2x2", "power", dict(use_cmfd=True, max_outer=3), "exact"),
    "anderson": ("1x1x2", "power", dict(accel="anderson"), "exact"),
    # IAEA-2D too: on IAEA-3D 1x1x2 BiCGSTAB at bench.SWEEP_TOL moves k by up
    # to 1.9e-6 (50 / 232 -> 49 / 216) under a 1e-15 change of the start flux
    # (the CPU, unsharded); on IAEA-2D 2x2 by 5e-16
    "bicgstab": ("iaea2d 2x2", "power", dict(inner_solver="bicgstab"), "exact"),
    "subcritical": ("1x1x2 subcritical", "subcritical", {}, "exact"),
    "coarse init": ("1x1x2", "coarse", {}, "exact"),
    "diag": ("1x1x2", "power", dict(a_mode="diag"), "diag"),
    "lumped": ("1x1x2", "power", dict(a_mode="lumped"), "lumped"),
    "wielandt": ("wielandt", "power", dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10,
                                           max_outer=60, accel="none", use_cmfd=True,
                                           cmfd_mode="wielandt", cmfd_lo_outers=20), "exact"),
    "direct_llt": ("iaea2d 2x2", "power", dict(inner_solver="direct"), "exact"),
}


def _v17b_problem(bench, name, dev):
    """(facade, host context, cut grid axis, options, run kind, coarse
    factors) of a [17b] variant; the dense factors are made on ``dev``."""
    import dataclasses

    problem, kind, over, a_mode = V17B[name]
    if problem == "wielandt":
        from neutfem_tpu_torch.power import SolveOptions

        s, ga = _v17_wielandt_facade(), 1
        opts = SolveOptions(**over)
        return s, _v17_host(s), ga, opts, kind, None
    if problem == "iaea2d 2x2":
        s, ga = _v17_facade(bench, "iaea2d", V17B_2D), 1
        host = _v17_host(s, extra=_v17_dense(s, dev) if kind == "power" and over.get(
            "inner_solver") == "direct" else None)
    else:
        s = _v17_facade(bench, "iaea3d", V17B_MESH, subcritical="subcritical" in problem,
                        tol=V17_TOL if name == "jacobi" else None)
        ga, host = 0, _v17_host(s, a_mode)
    opts = dataclasses.replace(s._opts(), **over)
    return s, host, ga, opts, kind, (1, 1, 2) if kind == "coarse" else None  # 19x19x19


def _v17b_rank(rank, world, init, args):
    """A rank of [17b]: gloo between the processes, the card shared
    (cuda:0; ``device``), float64; every variant of ``V17B`` on the rank's
    slab.
    Returns {variant: (value, outers, inners, history, gathered flux on
    rank 0)}."""
    import torch
    import torch.distributed as dist

    names, device = args
    if device == "cuda":
        torch.cuda.set_device(0)
    from neutfem_tpu_torch import bench, parallel

    dev = torch.device(device)
    mesh = parallel.device_mesh("gloo", init_method=init, rank=rank, world_size=world)
    out = {}
    for name in names:
        s, host, ga, opts, kind, factors = _v17b_problem(bench, name, dev)
        fes = s._fes
        ctx = parallel.shard_context(host, mesh, fes, ga, device=dev, dtype=torch.float64)
        phi0 = parallel.shard_state(torch.ones((s._ng, *fes.mesh.shape, 1), dtype=torch.float64),
                                    mesh, ga, device=dev)
        got = _v17_timed(kind, s, opts, ctx, phi0, dev, torch.float64,
                         (mesh, parallel._axis_map(mesh, ga)), factors, warm=False)
        phi = parallel.gather_state(got["res"]["phi"], mesh, ga)
        out[name] = {"value": got["value"], "outers": got["outers"], "inners": got["inners"],
                     "history": got["history"], "ms": got["ms"],
                     "collectives": got["launches"]["collectives"],
                     "phi": phi.cpu().numpy() if rank == 0 else None}
        dist.barrier()
    return out


def _v17b_cpu(bench, names):
    """[17b]'s references: every variant unsharded on the CPU, float64:
    {variant: (value, outers, flux)}."""
    import torch

    from neutfem_tpu_torch.ops.context import context_to_device

    cpu, out = torch.device("cpu"), {}
    for name in names:
        s, host, _, opts, kind, factors = _v17b_problem(bench, name, cpu)
        ctx = context_to_device(*host, 1, cpu, torch.float64)
        phi0 = torch.ones((s._ng, *s._fes.mesh.shape, 1), dtype=torch.float64)
        res = _v17_run(kind, s, opts, ctx, phi0, cpu, torch.float64, factors=factors)
        out[name] = (res["value"], res["outer_iterations"], res["phi"].numpy())
    return out


def _v17_rows(s, host, card, rows, launches):
    """[17c]: K5 y / x and K4 on rank 0's restaged slab of a two-way z cut
    of IAEA-3D 6x6x4 ((2, 1, 38, 114, 114): both groups, as the Jacobi sweep
    runs them), K1's batch on rank 0's slab of a two-way y cut ((2, 1, 76,
    57, 114)), each against its plain version at those shapes (random flux,
    accumulator and rhs) with the launches of [17a]'s Jacobi paths
    (``launches``: z cut, y cut)."""
    import types

    import numpy as np
    import torch

    from neutfem_tpu_torch import parallel

    fes = s._fes
    dirs = {di.axis: di for di in fes.dirs}
    rng = np.random.default_rng(17)
    for ga, cut in ((0, "z"), (1, "y")):
        # rank 0 of two along the cut: its slab, sliced as a world of two would
        # (no transport: RT0 has no block preconditioner to reduce over it)
        half = types.SimpleNamespace(axis_names=(parallel.SPATIAL_AXIS,),
                                     sizes={parallel.SPATIAL_AXIS: 2},
                                     coords={parallel.SPATIAL_AXIS: 0}, world=None)
        ctx = parallel.shard_context(host, half, fes, ga, device="cuda", dtype=torch.float32)
        shape = (2, 1, *ctx["C"].shape[-3:])
        v, acc0 = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                   device="cuda") for _ in range(2))
        label = f"[17c] rank 0's slab of a two-way {cut} cut, IAEA-3D 6x6x4"
        kernels = ((("K5", "y", 1), ("K5", "x", 2)) if cut == "z" else (("K1 batch", "z", 0),))
        for kid, key, axis in kernels:
            row = _batched_case(kid, key, ctx, dirs[axis], v, acc0, card, label,
                                (K5_REPLACES if kid == "K5" else ROWS_REPLACES)[key])
            row["launches"] = launches[cut][row.pop("key")]
            rows[f"{kid} {key} [17] slab"] = row
        if cut == "z":
            di = dirs[0]
            key = f"d{di.d}"
            dinv = ctx[f"tri_part_dinv_{key}"].unsqueeze(1).expand(shape).contiguous()
            lsh = list(shape)
            lsh[2] -= 1
            ll = ctx[f"tri_part_l_{key}"].unsqueeze(1).expand(lsh).contiguous()
            r = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda")
            row = _thomas_rows_case("group-batched partitioned segment, z cut (" + label[6:] +
                                    ", random rhs)", r, dinv, ll, -3, K4_REPLACES["z"], card)
            row.pop("key")
            row["launches"] = launches["z"]["thomas_rows"]
            rows["K4 [17] batched segment"] = row


def _v17_line(what, got, ref=None, card=""):
    beside = (f"; unsharded {ref['value']!r}, {ref['outers']} / {ref['inners']}, "
              f"{ref['ms']:.3f} ms/outer" if ref else "")
    cg = got["cg"]
    print(f"    {what}: {got['value']!r}, {got['outers']} / {got['inners']}, {got['ms']:.3f} "
          f"ms/outer{beside} ({card}); CG {cg['solves']} solves, {cg['replays']} replays, "
          f"{cg['eager_solves']} eager; {got['launches']['collectives']} collectives")
    print(f"      launches {{{', '.join(f'{k}: {v}' for k, v in got['launches'].items() if v)}}}")


def _sharded_variants(bench, dev, card, rows):
    """Phase [17]: the solver variants under a sharding scope on the card,
    each path with its own counts (module docstring).  Adds [17c]'s rows."""
    import concurrent.futures
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from neutfem_tpu_torch import parallel
    from neutfem_tpu_torch.ops.context import context_to_device

    f32, f64 = torch.float32, torch.float64
    t_all = t0 = time.perf_counter()
    mesh = parallel.device_mesh("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
    print(f"[17a] the variants under a sharding scope, world of one over {mesh.backend}: "
          "IAEA-3D 6x6x4 RT0-P0 float32 at bench.SWEEP_TOL unless stated, each sharded and "
          "unsharded in this call")
    s = _v17_facade(bench, "iaea3d", V17_MESH)
    fes, ng = s._fes, s._ng
    host = _v17_host(s)
    opts = s._opts()
    whole = context_to_device(*host, 1, dev, f32)
    cuts = {ga: (parallel.shard_context(host, mesh, fes, ga, device=dev, dtype=f32),
                 (mesh, parallel._axis_map(mesh, ga))) for ga in (0, 1)}
    flat = torch.ones((ng, *fes.mesh.shape, 1), dtype=f32, device=dev)
    slab = {ga: parallel.shard_state(flat, mesh, ga) for ga in (0, 1)}

    def both(kind, o, what, ga=0, ctx_whole=whole, ctx_cut=None, dtype=f32, factors=None,
             start=flat, ref=None, fac=s):
        if ref is None:
            ref = _v17_timed(kind, fac, o, ctx_whole, start, dev, dtype, factors=factors)
        c, scope = ctx_cut or cuts[ga]
        got = _v17_timed(kind, fac, o, c, parallel.shard_state(start, mesh, ga), dev, dtype,
                         scope, factors)
        _v17_line(f"{what}, {'zy'[ga]} cut", got, ref, card)
        cg = got["cg"]
        if dev.type == "cuda" and cg["solves"] and (cg["replays"] <= 0 or cg["eager_solves"]):
            raise RuntimeError(f"[17a] {what}: the CG did not replay its graphs under NCCL")
        return got, ref

    cheb = _v17_timed("power", s, opts, whole, flat, dev, f32)
    _v17_line("Chebyshev (unsharded; CMFD's and coarse init's reference)", cheb, card=card)

    # the Jacobi sweep: every group in one batched CG on the slab
    jopts = dataclasses.replace(opts, sweep="jacobi")
    launches, ref = {}, None
    for ga, cut in ((0, "z"), (1, "y")):
        got, ref = both("power", jopts, "Jacobi sweep", ga, ref=ref)
        L = launches[cut] = got["launches"]
        if not (abs(got["value"] - ref["value"]) <= SWEEP_KEFF_TOL and got["outers"] < 600):
            raise RuntimeError(f"[17a] Jacobi sweep {cut} cut: k {got['value']} not within "
                               f"{SWEEP_KEFF_TOL} of {ref['value']}, or capped")
        need = (("y_batched_rows", "x_batched_rows", "thomas_rows") if cut == "z"
                else ("z_batched_rows", "x_batched_rows"))
        if dev.type == "cuda" and (any(L[k] < got["inners"] for k in need)
                                   or any(L[k] for k in Z_KEYS)):
            raise RuntimeError(f"[17a] Jacobi sweep {cut} cut: {need} not launched every CG "
                               "iteration, or a one-group kernel ran")
    # CMFD "fixed" and coarse init against the Chebyshev k
    for what, kind, o, factors in (("CMFD \"fixed\"", "power",
                                    dataclasses.replace(opts, use_cmfd=True), None),
                                   (f"coarse init {V17_COARSE}", "coarse", opts, V17_COARSE)):
        got, ref = both(kind, o, what, factors=factors)
        if not abs(got["value"] - cheb["value"]) <= VARIANT_KEFF_TOL:
            raise RuntimeError(f"[17a] {what}: k {got['value']} not within {VARIANT_KEFF_TOL} of "
                               f"the Chebyshev k {cheb['value']}")
    # Anderson on [14a]'s row.  Its float32 counts on IAEA-3D fall in one of
    # two rounding basins (57-59 or 82-92 outers, [14a]): every k is held to
    # the anchor, and each sharded solve from the flat flux and from four
    # start fluxes perturbed by one float32 ulp must land in a basin the
    # unsharded solve visits from those five starts: its outers and inners
    # within INNERS_REL of one unsharded solve's
    _, _, atol = next(c for c in bench.ACCEL_CONFIGS if c[0] == "iaea3d")
    s.set_tol(*atol)
    s.set_acceleration("anderson")
    aopts = s._opts()
    s.set_tol(*bench.SWEEP_TOL)
    s.set_acceleration("chebyshev")
    anchor = ACCEL_ANCHORS[("iaea3d", "anderson")]
    got, ref = both("power", aopts, "Anderson (ACCEL_CONFIGS' tolerances)")
    runs = {"sharded": [(got["value"], got["outers"], got["inners"])],
            "unsharded": [(ref["value"], ref["outers"], ref["inners"])]}
    for seed in ACCEL_PERTURB_SEEDS:  # rounding_probe.perturbed_start's start flux
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(flat.shape, generator=g, device=dev, dtype=f64)
        start = flat * (1 + 1e-7 * noise.to(f32))
        for what, c, scope, phi in (("sharded", cuts[0][0], cuts[0][1],
                                     parallel.shard_state(start, mesh, 0)),
                                    ("unsharded", whole, None, start)):
            r = _v17_run("power", s, aopts, c, phi, dev, f32, scope)
            runs[what].append((r["value"], r["outer_iterations"], r["inner_iterations"]))
    print(f"    Anderson from the flat flux and four perturbed starts (k, outers, inners), "
          f"anchor {anchor}: sharded {runs['sharded']}; unsharded {runs['unsharded']}")
    def basin(o, i):
        return any(abs(o - uo) <= INNERS_REL * uo and abs(i - ui) <= INNERS_REL * ui
                   for _, uo, ui in runs["unsharded"])

    if any(abs(k - anchor[0]) > KEFF_TOL for k, _, _ in runs["sharded"] + runs["unsharded"]) or (
            not all(basin(o, i) for _, o, i in runs["sharded"])):
        raise RuntimeError(f"[17a] Anderson: k off the anchor {anchor}, or a sharded solve in "
                           f"no basin of the unsharded solves: {runs}")
    # BiCGSTAB at float64 against the float64 CG
    whole64 = context_to_device(*host, 1, dev, f64)
    cut64 = (parallel.shard_context(host, mesh, fes, 0, device=dev, dtype=f64), cuts[0][1])
    flat64 = flat.to(f64)
    cg64 = _v17_timed("power", s, opts, whole64, flat64, dev, f64)
    _v17_line("CG float64 (unsharded; BiCGSTAB's reference)", cg64, card=card)
    got, _ = both("power", dataclasses.replace(opts, inner_solver="bicgstab"),
                  "BiCGSTAB float64", ctx_whole=whole64, ctx_cut=cut64, dtype=f64, start=flat64)
    if not abs(got["value"] - cg64["value"]) <= VARIANT_PAIR_TOL:
        raise RuntimeError(f"[17a] BiCGSTAB: k {got['value']} not within {VARIANT_PAIR_TOL} of "
                           f"the CG's {cg64['value']}")
    del whole64, cut64
    # the subcritical solve of [14c]: M at float32 against the float64 M
    sub = _v17_facade(bench, "iaea3d", V17_MESH, subcritical=True)
    hsub = _v17_host(sub)
    sopts = sub._opts()
    m64 = _v17_timed("subcritical", sub, sopts, context_to_device(*hsub, 1, dev, f64), flat64,
                     dev, f64)
    csub = (parallel.shard_context(hsub, mesh, fes, 0, device=dev, dtype=f32), cuts[0][1])
    got, _ = both("subcritical", sopts, "subcritical M", ctx_whole=context_to_device(
        *hsub, 1, dev, f32), ctx_cut=csub, fac=sub)
    print(f"      M float64 (unsharded) {m64['value']!r}")
    if not abs(got["value"] / m64["value"] - 1.0) <= SUBCRIT_M_REL:
        raise RuntimeError(f"[17a] subcritical: M {got['value']} not within {SUBCRIT_M_REL} of "
                           f"{m64['value']}")
    del sub, hsub, csub
    # diag and lumped: at 3x3x2 on their anchors, at 6x6x4 beside the
    # unsharded solve; no K1-K4 (no kernel in the JAX package either)
    small = _v17_facade(bench, "iaea3d", V17_SMALL, tol=bench.FULL_TOL)
    for a_mode, anchor in (("diag", DIAG_ANCHOR), ("lumped", LUMPED_ANCHOR)):
        o3 = dataclasses.replace(small._opts(), a_mode=a_mode)
        h3 = _v17_host(small, a_mode)
        f3 = torch.ones((ng, *small._fes.mesh.shape, 1), dtype=f32, device=dev)
        c3 = parallel.shard_context(h3, mesh, small._fes, 0, device=dev, dtype=f32)
        got = _v17_timed("power", small, o3, c3, parallel.shard_state(f3, mesh, 0), dev, f32,
                         cuts[0][1])
        _v17_line(f"{a_mode} 3x3x2 (anchor {anchor}), z cut", got, card=card)
        _check_anchor(f"[17a] {a_mode} 3x3x2", got["value"], got["outers"], got["inners"], anchor)
        h6 = _v17_host(s, a_mode)
        s.set_tol(*bench.FULL_TOL)
        o6 = dataclasses.replace(s._opts(), a_mode=a_mode)
        s.set_tol(*bench.SWEEP_TOL)
        got, ref = both("power", o6, f"{a_mode} 6x6x4 (bench.FULL_TOL)",
                        ctx_whole=context_to_device(*h6, 1, dev, f32),
                        ctx_cut=(parallel.shard_context(h6, mesh, fes, 0, device=dev, dtype=f32),
                                 cuts[0][1]))
        for r in (got, ref):
            if any(r["launches"][k] for k in (*Z_KEYS, "thomas_rows", "z_batched_rows",
                                               *K5_KEYS)):
                raise RuntimeError(f"[17a] {a_mode}: K1-K4 launched on a diagonal A-solve")
    del small
    # DIRECT_LLT on IAEA-2D 3x3, y cut, against its CG k
    d2 = _v17_facade(bench, "iaea2d", V17_2D)
    h2 = _v17_host(d2, extra=_v17_dense(d2, dev))
    f2 = torch.ones((ng, *d2._fes.mesh.shape, 1), dtype=f32, device=dev)
    w2 = context_to_device(*h2, 1, dev, f32)
    cg2 = _v17_timed("power", d2, d2._opts(), w2, f2, dev, f32)
    _v17_line("CG IAEA-2D 3x3 (unsharded; DIRECT_LLT's reference)", cg2, card=card)
    c2 = (parallel.shard_context(h2, mesh, d2._fes, 1, device=dev, dtype=f32),
          (mesh, parallel._axis_map(mesh, 1)))
    got, _ = both("power", dataclasses.replace(d2._opts(), inner_solver="direct"),
                  f"DIRECT_LLT IAEA-2D 3x3 ({d2._fes.n_phi} flux DOFs)", 1, w2, c2, start=f2,
                  fac=d2)
    if not abs(got["value"] - cg2["value"]) <= DIRECT_KEFF_TOL:
        raise RuntimeError(f"[17a] DIRECT_LLT: k {got['value']} not within {DIRECT_KEFF_TOL} of "
                           f"its CG k {cg2['value']}")
    del d2, h2, c2, w2
    dist.destroy_process_group()
    print(f"    [17a] {time.perf_counter() - t0:.1f} s")

    # (c) the kernels at rank 0's slab of a two-way cut, with (a)'s launches
    t0 = time.perf_counter()
    print(f"[17c] K5 y / x, K1's batch and K4 at rank 0's slab of a two-way cut ({card})")
    _v17_rows(s, host, card, rows, launches)
    print(f"    [17c] {time.perf_counter() - t0:.1f} s")

    # (b) the gloo pair (processes of its own) against the CPU's unsharded
    # runs, made in a thread of this process meanwhile
    t0 = time.perf_counter()
    names_b = tuple(V17B)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_refs = pool.submit(_v17b_cpu, bench, names_b)
        ranks = parallel.spawn_ranks(_v17b_rank, 2, f"tcp://localhost:{_free_port()}",
                                     (names_b, dev.type), RANK_TIMEOUT)
        refs = cpu_refs.result()
    per = ranks
    print("[17b] two ranks sharing the card over gloo (host-staged: the eager CG block loop), "
          "float64, IAEA-3D 1x1x2 z cut (CMFD, BiCGSTAB and DIRECT_LLT: IAEA-2D 2x2, CMFD "
          "\"wielandt\": 6x4 cells, each a y cut) against the unsharded run on the CPU")
    for name in names_b:
        a, b = per[0][name], per[1][name]
        if (a["value"], a["outers"], a["inners"]) != (b["value"], b["outers"], b["inners"]) or (
                a["history"] is not None and not np.array_equal(a["history"], b["history"])):
            raise RuntimeError(f"[17b] {name}: the ranks disagree")
        v_cpu, o_cpu, phi_cpu = refs[name]
        rel = _flux_rel(a["phi"], phi_cpu)
        dv = a["value"] - v_cpu
        flux_tol = 1e-6 if name.startswith("cmfd") else SHARD_F64_TOL
        print(f"    {name}: {a['value']!r} vs CPU {v_cpu!r} (d {dv:+.2e}), outers {a['outers']} / "
              f"{o_cpu}, inners {a['inners']}, flux rel {rel:.2e}; {a['ms']:.1f} ms/outer "
              f"TRANSPORT-BOUND, {a['collectives']} collectives a rank ({card})")
        if not (abs(dv) <= SHARD_F64_TOL * max(1.0, abs(v_cpu)) and a["outers"] == o_cpu
                and rel <= flux_tol):
            raise RuntimeError(f"[17b] {name}: the sharded run on the card disagrees with the CPU")
    print(f"    [17b] {time.perf_counter() - t0:.1f} s; [17] "
          f"{time.perf_counter() - t_all:.1f} s")


# [18] the scan cut-axis solve (``ops/parttri.tridiag_solve_scan``): the cut
# directions where the JAX package takes its associative scan.  [18c]'s
# problems: a small random core with an axis of 2 cells (s = 1 needs p = n;
# no benchmark core has such an axis), IAEA-2D 2x2 with y PERIODIC, IAEA-3D
# 1x1x2 under NEUTFEM_PARTTRI=0 (name -> (problem, cut grid axis, env))
V18C = {"one cell a rank": ("random", 1, {}),
        "periodic y": ("iaea2d periodic y", 1, {}),
        "parttri=0": ("1x1x2", 0, {"NEUTFEM_PARTTRI": "0"})}
V18C_TOL = (1e-9, 1e-8, 1e-11, 200, 1000)  # the random core's: tight, float64


def _per_y():
    from neutfem_tpu_torch.compat import BCType

    return {(1, False): (BCType.PERIODIC, 0.0), (1, True): (BCType.PERIODIC, 0.0)}


def _v18_random():
    """[18c]'s one-cell problem: [15f]'s random 2-group recipe on 6x2 cells
    (the y axis of 2 cells: one a rank of two), vacuum faces; a facade-like
    holder as ``_v17_wielandt_facade``'s."""
    import types

    import numpy as np
    import torch

    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.mesh import CartesianMesh, boundary_attribute
    from neutfem_tpu_torch.ops.context import build_context
    from neutfem_tpu_torch.power import SolveOptions

    rng = np.random.default_rng(18)
    shape = (1, 2, 6)
    mesh = CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (6, 2)])
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(2):
        for up in (False, True):
            bcs.set(boundary_attribute(2, ax, up), BCKind.DIRICHLET)
    fes = make_fespace(mesh, 0, 0)
    ctx = build_context(fes, 2, xs, bcs, "cpu", torch.float64)
    opts = SolveOptions(**dict(zip(("tol_keff", "tol_flux", "inner_tol", "max_outer",
                                    "max_inner"), V18C_TOL)))
    return types.SimpleNamespace(_fes=fes, _ng=2, _xs=xs, _bcs=bcs,
                                 _context=lambda a_mode="exact": ctx, _opts=lambda: opts)


def _v18c_problem(bench, name):
    """(facade, host context, cut grid axis, options, env) of a [18c] case,
    float64 on the CPU."""
    problem, ga, env = V18C[name]
    if problem == "random":
        s = _v18_random()
    elif problem == "iaea2d periodic y":
        s = _v17_facade(bench, "iaea2d", V17B_2D, bc=_per_y())
    else:
        s = _v17_facade(bench, "iaea3d", V17B_MESH)
    return s, _v17_host(s), ga, s._opts(), env


def _v18c_rank(rank, world, init, args):
    """A rank of [18c]: gloo between the processes, the card shared (cuda:0),
    float64; every case of ``V18C`` on the rank's slab (its context sliced
    under the case's env).  Returns {case: (k, counts, history, the scan
    and partitioned applications, gathered flux on rank 0)}."""
    import torch
    import torch.distributed as dist

    names, device = args
    if device == "cuda":
        torch.cuda.set_device(0)
    from neutfem_tpu_torch import bench, parallel

    dev = torch.device(device)
    mesh = parallel.device_mesh("gloo", init_method=init, rank=rank, world_size=world)
    out = {}
    for name in names:
        s, host, ga, opts, env = _v18c_problem(bench, name)
        with bench.env(**env):
            ctx = parallel.shard_context(host, mesh, s._fes, ga, device=dev, dtype=torch.float64)
        phi0 = parallel.shard_state(torch.ones((s._ng, *s._fes.mesh.shape, 1),
                                               dtype=torch.float64), mesh, ga, device=dev)
        got = _v17_timed("power", s, opts, ctx, phi0, dev, torch.float64,
                         (mesh, parallel._axis_map(mesh, ga)), warm=False)
        phi = parallel.gather_state(got["res"]["phi"], mesh, ga)
        L = got["launches"]
        out[name] = {"value": got["value"], "outers": got["outers"], "inners": got["inners"],
                     "history": got["history"], "ms": got["ms"], "scan": L["scan"],
                     "parttri": L["parttri"], "collectives": L["collectives"],
                     "phi": phi.cpu().numpy() if rank == 0 else None}
        dist.barrier()
    return out


def _v18c_cpu(bench, names):
    """[18c]'s references: every case unsharded on the CPU, float64:
    {case: (k, outers, flux)}."""
    import torch

    from neutfem_tpu_torch.ops.context import context_to_device

    cpu, out = torch.device("cpu"), {}
    for name in names:
        s, host, _, opts, _ = _v18c_problem(bench, name)
        ctx = context_to_device(*host, 1, cpu, torch.float64)
        phi0 = torch.ones((s._ng, *s._fes.mesh.shape, 1), dtype=torch.float64)
        res = _v17_run("power", s, opts, ctx, phi0, cpu, torch.float64)
        out[name] = (res["value"], res["outer_iterations"], res["phi"].numpy())
    return out


def _scan_cuts(bench, dev, card):
    """Phase [18]: the scan cut-axis solve on the card, each path with its
    own counts (module docstring)."""
    import concurrent.futures
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from neutfem_tpu_torch import data, parallel
    from neutfem_tpu_torch.compat import BCType
    from neutfem_tpu_torch.ops.context import build_host_context, context_to_device

    f32 = torch.float32
    t_all = t0 = time.perf_counter()
    mesh = parallel.device_mesh("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
    print(f"[18a] the scan cut under NEUTFEM_PARTTRI=0 beside the partitioned cut, world of one "
          f"over {mesh.backend}: IAEA-3D 6x6x4 RT0-P0 float32 (bench.FULL_TOL), on [5]'s anchors")
    run = bench.BenchmarkRun(data.BENCHMARKS["iaea3d"], 6, 4, device="cpu", dtype=f32)
    s = run.solver
    s.set_tol(*bench.FULL_TOL)
    fes, ng, opts = s._fes, s._ng, s._opts()
    host = build_host_context(fes, ng, s._xs, s._bcs, marshak_d_factor=True)
    del run
    flat = torch.ones((ng, *fes.mesh.shape, 1), dtype=f32, device=dev)
    for ga, cut in ((0, "z"), (1, "y")):
        scope = (mesh, parallel._axis_map(mesh, ga))
        got = {}
        for path, env in (("partitioned", {}), ("scan", {"NEUTFEM_PARTTRI": "0"})):
            with bench.env(**env):
                ctx = parallel.shard_context(host, mesh, fes, ga, device=dev, dtype=f32)
            got[path] = r = _v17_timed("power", s, opts, ctx, parallel.shard_state(flat, mesh, ga),
                                       dev, f32, scope)
            del ctx
            _v17_line(f"{path}, {cut} cut", r, card=card)
            _check_anchor(f"[18a] {path} {cut} cut", r["value"], r["outers"], r["inners"],
                          (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
            cg, L = r["cg"], r["launches"]
            if cg["replays"] < cg["solves"] or cg["eager_solves"]:
                raise RuntimeError(f"[18a] {path} {cut} cut: the CG did not replay its graphs")
            uncut = {"z": ("y_rows", "x_rows"), "y": ("z_rows", "x_rows")}[cut]
            if any(L[k] < r["inners"] for k in uncut):
                raise RuntimeError(f"[18a] {path} {cut} cut: the uncut directions' kernels did "
                                   "not run every CG iteration")
        sc, pt = got["scan"]["launches"], got["partitioned"]["launches"]
        if not (sc["scan"] >= got["scan"]["inners"] and sc["parttri"] == 0 and pt["scan"] == 0
                and pt["parttri"] >= got["partitioned"]["inners"]):
            raise RuntimeError(f"[18a] {cut} cut: scan {sc['scan']} / parttri {sc['parttri']} on "
                               f"the scan path, {pt['scan']} / {pt['parttri']} on the "
                               "partitioned one")
        print(f"    {cut} cut: scan {got['scan']['ms']:.3f} ms/outer against the partitioned "
              f"{got['partitioned']['ms']:.3f}, ratio "
              f"{got['scan']['ms'] / got['partitioned']['ms']:.2f}; K1-K3 on the scan path "
              f"z {sc['z_rows']}, y {sc['y_rows']}, x {sc['x_rows']}; scan applications "
              f"{sc['scan']} ({card})")
    del host
    print(f"    [18a] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("[18b] a PERIODIC cut direction at full width, y cut, world of one over nccl, float32 "
          "at bench.SWEEP_TOL: IAEA-3D 6x6x4 with the lateral faces PERIODIC against its "
          "unsharded run and the MIRROR quadrant (quart_so); KOEBERG 32x32 y PERIODIC against "
          "the half core (moitie_s)")
    lateral = {f: (BCType.PERIODIC, 0.0) for f in bench.LATERAL}
    for core, mesh_n, bc, ref_kw in (
            ("iaea3d", (6, 4), lateral,
             dict(domain="quart_so", bc={f: (BCType.MIRROR, 0.0) for f in bench.LATERAL})),
            ("koeberg2d", (32,), _per_y(),
             dict(domain="moitie_s", bc={(1, True): (BCType.MIRROR, 0.0)}))):
        per = _v17_facade(bench, core, mesh_n, bc=bc)
        host = _v17_host(per)
        start = torch.ones((per._ng, *per._fes.mesh.shape, 1), dtype=f32, device=dev)
        ctx = parallel.shard_context(host, mesh, per._fes, 1, device=dev, dtype=f32)
        whole = context_to_device(*host, 1, dev, f32) if core == "iaea3d" else None
        del host
        got = _v17_timed("power", per, per._opts(), ctx, parallel.shard_state(start, mesh, 1),
                         dev, f32, (mesh, parallel._axis_map(mesh, 1)))
        ref = (_v17_timed("power", per, per._opts(), whole, start, dev, f32) if whole is not None
               else None)
        _v17_line(f"{core} PERIODIC y cut", got, ref, card)
        del ctx, whole, per
        q = bench.BenchmarkRun(data.BENCHMARKS[core], *mesh_n, device=dev, dtype=f32, **ref_kw)
        k_q = q.solve(tol=bench.SWEEP_TOL)
        print(f"      {ref_kw['domain']} {q.solver._mesh.shape}: keff {k_q!r}, "
              f"{q.solver._last_outers} / {q.solver._last_inners}; sharded - it "
              f"{got['value'] - k_q:+.2e}" + (f", sharded - unsharded "
                                              f"{got['value'] - ref['value']:+.2e}" if ref else ""))
        del q
        L = got["launches"]
        if not (abs(got["value"] - k_q) <= VARIANT_PAIR_TOL and L["scan"] >= got["inners"]
                and L["parttri"] == 0 and (ref is None or abs(got["value"] - ref["value"])
                                           <= SHARD_KEFF_TOL)):
            raise RuntimeError(f"[18b] {core}: the periodic y cut is off its references, or the "
                               f"scan did not run every CG iteration ({L['scan']} / "
                               f"{got['inners']})")
    dist.destroy_process_group()
    print(f"    [18b] {time.perf_counter() - t0:.1f} s")

    # (c) the gloo pair (processes of its own) against the CPU's unsharded
    # runs, made in a thread of this process meanwhile
    t0 = time.perf_counter()
    names = tuple(V18C)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_refs = pool.submit(_v18c_cpu, bench, names)
        ranks = parallel.spawn_ranks(_v18c_rank, 2, f"tcp://localhost:{_free_port()}",
                                     (names, dev.type), RANK_TIMEOUT)
        refs = cpu_refs.result()
    print("[18c] two ranks sharing the card over gloo, float64, against the unsharded run on "
          "the CPU: a random 6x2 core (one y cell a rank), IAEA-2D 2x2 y PERIODIC (y cut), "
          "IAEA-3D 1x1x2 under NEUTFEM_PARTTRI=0 (z cut)")
    for name in names:
        a, b = ranks[0][name], ranks[1][name]
        if (a["value"], a["outers"], a["inners"]) != (b["value"], b["outers"], b["inners"]) or (
                not np.array_equal(a["history"], b["history"])):
            raise RuntimeError(f"[18c] {name}: the ranks disagree")
        v_cpu, o_cpu, phi_cpu = refs[name]
        rel, dv = _flux_rel(a["phi"], phi_cpu), a["value"] - v_cpu
        print(f"    {name}: {a['value']!r} vs CPU {v_cpu!r} (d {dv:+.2e}), outers "
              f"{a['outers']} / {o_cpu}, inners {a['inners']}, flux rel {rel:.2e}; scan "
              f"{a['scan']}, partitioned {a['parttri']}; {a['ms']:.1f} ms/outer "
              f"TRANSPORT-BOUND, {a['collectives']} collectives a rank ({card})")
        if not (abs(dv) <= SHARD_F64_TOL and a["outers"] == o_cpu and rel <= SHARD_F64_TOL
                and a["scan"] >= a["inners"] and a["parttri"] == 0):
            raise RuntimeError(f"[18c] {name}: the sharded run on the card disagrees with the CPU, "
                               "or the scan did not run")
    print(f"    [18c] {time.perf_counter() - t0:.1f} s; [18] {time.perf_counter() - t_all:.1f} s")


def _literature_paths(dev, card, reset_counts, counts, cg_line, rows):
    """Phase [19]: the literature cores on the card through the port's entry
    points (``validate``, ``runner``), each path with its own counts (module
    docstring).  Adds the rows of K2 / K3 and K4′ at ZION 68x68's widths to
    ``rows``."""
    import dataclasses

    import numpy as np
    import torch

    from neutfem_tpu_torch import runner, validate
    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.ops import thomas
    from neutfem_tpu_torch.power import ctx_group

    f32, f64 = torch.float32, torch.float64
    t_all = t0 = time.perf_counter()
    print("[19a] the five literature cores: neutfem_tpu_torch.validate.validate(), float32 at "
          "bench.FULL_TOL")
    reset_counts()
    vrows = validate.validate()  # raises SystemExit when a core is out of its pcm bound
    for r in vrows:
        name, L, inners = r["name"], r["launches"], r["inner_iterations"]
        print(f"    {name} {r['mesh']}: k {r['keff']:.7f}, pcm {r['pcm']:+.2f} (bound "
              f"{r['bound']}), {r['outer_iterations']} / {inners} (anchors "
              f"{VALIDATE_ANCHORS[name]}), {1e3 * r['solve_s'] / r['outer_iterations']:.3f} "
              f"ms/outer, build + solve {r['wall_s']:.2f} s, {r['preconditioner']}; launches "
              f"{L} ({card})")
        cg_line(r["cg"])
        _check_anchor(f"[19a] {name} {r['mesh']}", r["keff"], r["outer_iterations"], inners,
                      VALIDATE_ANCHORS[name])
        every = Z_KEYS if name == "iaea3d" else ("y_rows", "x_rows")
        if any(L.get(k, 0) < inners for k in every):
            raise RuntimeError(f"[19a] {name}: {every} not launched every CG iteration")
        if r["n_cells"] >= 65536 and name != "iaea3d":  # twogrid.AUTO_TG_MIN_CELLS
            if r["preconditioner"] != "twogrid" or L.get("thomas_wide_rows", 0) <= 0:
                raise RuntimeError(f"[19a] {name}: preconditioner {r['preconditioner']!r}, "
                                   f"K4′ launches {L.get('thomas_wide_rows', 0)}")
        elif name == "iaea2d" and r["preconditioner"] != "jacobi":
            raise RuntimeError(f"[19a] iaea2d 8x8: preconditioner {r['preconditioner']!r}, a "
                               "two-grid level attached below its threshold")
        elif name == "iaea3d" and L.get("thomas_rows", 0) <= 0:
            raise RuntimeError("[19a] iaea3d 6x6x4: K4 not launched in compute_current")
    dev_pct = vrows[0]["power_max_dev_pct"]
    print(f"    IAEA-2D 8x8 assembly power factors: largest |deviation| from the published map "
          f"{dev_pct:.3f}% (bound {POWER_DEV_PCT}%)")
    if not dev_pct < POWER_DEV_PCT:
        raise RuntimeError(f"[19a] IAEA-2D 8x8 power map off by {dev_pct}%")
    print(f"    [19a] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("[19b] the fine 2D parity ladder's new rows: neutfem_tpu_torch.validate.run_ladder(), "
          "float32 at validate.LADDER_TOL")
    reset_counts()
    lrows = (validate.run_ladder(cores=("zion2d",), meshes=(64, 68))
             + validate.run_ladder(cores=("iaea2d",), meshes=(32,)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ladder = {}
    for r in lrows:
        core, n = r["core"], int(r["mesh"].split("x")[0])
        k_a, o_a = LADDER_ANCHORS[(core, n)]
        L, inners, outers = r["launches"], r["inner_iterations"], r["outer_iterations"]
        print(f"    {core} {r['mesh']} ({r['n_cells']} cells): k {r['keff']:.7f} (anchor {k_a}), "
              f"pcm {r['pcm']:+.2f}, {outers} / {inners} (outers anchor {o_a}), "
              f"{r['ms_per_outer']:.3f} ms/outer, first solve "
              f"{r['compile_plus_first_solve_s']:.2f} s, {r['preconditioner']}; launches {L} "
              f"({card})")
        cg_line(r["cg"])
        if not (abs(r["keff"] - k_a) <= LADDER_KEFF_TOL and abs(outers - o_a) <= OUTERS_TOL):
            raise RuntimeError(f"[19b] {core} {r['mesh']}: k {r['keff']} / {outers} outers, "
                               f"anchors {k_a} +- {LADDER_KEFF_TOL} / {o_a} +- {OUTERS_TOL}")
        if (min(L.get("y_rows", 0), L.get("x_rows", 0)) < inners
                or r["preconditioner"] != "twogrid" or L.get("thomas_wide_rows", 0) <= 0):
            raise RuntimeError(f"[19b] {core} {r['mesh']}: K2 / K3 not every CG iteration, no "
                               "two-grid level or no K4′")
        if core == "zion2d":
            m = round(r["n_cells"] ** 0.5)  # compute_current's y: (2, 1, 1, m + 1, m)
            tile = thomas.wide_tile(m + 1, 2, m, sms)
            if tile != (4, 64):
                raise RuntimeError(f"[19b] ZION {n}x{n}: K4′ tile {tile}, not (4, 64)")
        ladder[(core, n)] = r
    print(f"    [19b] {time.perf_counter() - t0:.1f} s")

    # [19c] the kernels at ZION 68x68's widths, each against its plain version,
    # on that core's own operands (a random flux / residual)
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    zrun = BenchmarkRun(BENCHMARKS["zion2d"], mesh_n=68, device=dev, dtype=f32)
    s = zrun.solver
    zfes, zctx = s._fes, s._ctx
    zctxg = ctx_group(zctx, 0)
    zshape = (1, *zfes.mesh.shape)
    zdirs = {di.d: di for di in zfes.dirs}
    print(f"[19c] kernels vs plain, ZION 68x68 {zfes.mesh.shape} group 0, float32 (build "
          f"{time.perf_counter() - t0:.1f} s; {card})")
    zv, zacc0, r1 = (torch.as_tensor(rng.standard_normal(zshape), dtype=f32, device=dev)
                     for _ in range(3))
    z68 = ladder[("zion2d", 68)]["launches"]
    for kid, key, d in (("K2", "y", 1), ("K3", "x", 0)):
        row = _rows_case(kid, key, zctxg, zdirs[d], zv, zacc0, card, " (2D, ZION 68x68)",
                         sweep=False)
        row["launches"] = z68[row.pop("key")]
        rows[f"{kid} ZION 68"] = row
    zphi = torch.as_tensor(rng.standard_normal((2, *zshape)), dtype=f32, device=dev)
    row = _wide_case("compute_current y (ZION 68x68)",
                     *_current_operands(zfes, zctx, zdirs[1], zphi)[:3], card, sweep=False)
    row["launches"] = z68[row.pop("key")]
    rows["K4′ ZION 68"] = row
    row = _wide_case("2D line preconditioner (ZION 68x68)", r1,
                     zctxg["precond_line_dinv"].unsqueeze(-4).expand(r1.shape).contiguous(),
                     zctxg["precond_line_l"].unsqueeze(-4).contiguous(), card, sweep=False)
    s.set_tol(*validate.LADDER_TOL)
    line_opts = dataclasses.replace(s._opts(), inner_precond="line")
    graph_l = _graph_case("ZION 68x68 group 0 (line preconditioner: K4′)", s, line_opts, 0, card)
    row["launches"] = graph_l.get(row.pop("key"), 0)
    if row["launches"] <= 0:
        raise RuntimeError("[19c] ZION 68x68 line preconditioner: the tiled K4′ did not run")
    rows["K4′ line ZION 68"] = row
    del zrun, s, zctx, zctxg, zv, zacc0, zphi, r1
    print(f"    [19c] {time.perf_counter() - t0:.1f} s")

    # [19d] float64, the card against the CPU, through runner.run_benchmark
    t0 = time.perf_counter()
    for core, n in (("biblis2d", 2), ("zion2d", 4)):
        got = {}
        for device in ("cpu", "cuda"):
            reset_counts()
            got[device] = runner.run_benchmark(core, mesh_n=n, adjoint=True, device=device,
                                               dtype=f64)
        L = counts()
        c, g = got["cpu"], got["cuda"]
        dk, dka = abs(g.keff - c.keff), abs(g.keff_adj - c.keff_adj)
        fass = float(np.max(np.abs(g.Fass - c.Fass)) / np.max(np.abs(c.Fass)))
        print(f"[19d] {core} {n}x{n} float64 adjoint: cuda k {g.keff!r} / k_adj {g.keff_adj!r} "
              f"({g.outer_iterations} outers), cpu {c.keff!r} / {c.keff_adj!r} "
              f"({c.outer_iterations}); |dk| {dk:.2e}, |dk_adj| {dka:.2e}, Fass rel {fass:.2e}; "
              f"K2 / K3 {L['y_rows']} / {L['x_rows']}")
        if (dk > 1e-9 or dka > 1e-9 or g.outer_iterations != c.outer_iterations or fass > 1e-9
                or min(L["y_rows"], L["x_rows"]) <= 0):
            raise RuntimeError(f"[19d] {core} {n}x{n}: the card disagrees with the CPU, or the "
                               "tiled K2 / K3 did not serve it")
        del got, c, g
    print(f"    [19d] {time.perf_counter() - t0:.1f} s")
    print(f"    [19] {time.perf_counter() - t_all:.1f} s")


# [20] the last entry points of the JAX system: the scaling ladder
# (neutfem_tpu_torch.scaling) at float32 and float64, the widest
# higher-order meshes the JAX package recorded, the kernels at the shapes
# these paths give them, and the examples.  Anchors of the float32 ladder,
# mesh -> (k, outers, inners): 6x6x4 from BENCH_r05.json (bench.py's row),
# 8x8x6 and 8x8x8 from BENCH_extra.json (the JAX package's TPU float32
# rows; the 8x8x6 one solved its axis-permuted problem, the port the mesh in
# its own order), 2x2x2 and 4x4x3 (no record exists) from the JAX package on
# a CPU at float32:
#   JAX_PLATFORMS=cpu python -m benchmarks.scaling --cpu --meshes 2x2x2,4x4x3
LADDER_ANCHORS_F32 = {"2x2x2": (1.028443, 34, 378), "4x4x3": (1.0289167, 34, 728),
                      "6x6x4": (1.029104, 34, 1068), "8x8x6": (1.0291827, 34, 1461),
                      "8x8x8": (1.0291848, 34, 1341)}
# the float32 ladder's k tolerance: KEFF_TOL below 2.6M cells, SCALE_KEFF_TOL
# (the float32 band of 8x8x8, above) at 2.6M and above
LADDER_WIDE_CELLS = 2_600_000
# the float64 ladder's rows against the JAX package on a CPU at float64
# (|dk| <= 1e-9 against the row's unrounded k, the same outers, inners
# within 2: PERF.md section 2's float64 standard), mesh -> (k, outers,
# inners).  The counts from
#   JAX_PLATFORMS=cpu python -m benchmarks.scaling --cpu --x64 --meshes 2x2x2,4x4x3
# (its k rounded to 7 digits: 1.0284114 and 1.0289154), the unrounded k from
# the same steps:
#   JAX_PLATFORMS=cpu python -c "from benchmarks.runner import BenchmarkRun;
#   from benchmarks.data import BENCHMARKS; r = BenchmarkRun(BENCHMARKS['iaea3d'],
#   mesh_n=2, mesh_nz=2); r.solve(tol=(1e-5, 1e-4, 1e-4, 200, 1000));
#   r.solver.reset_flux(); print(repr(r.solver.SolveKeff()), r.solver._last_outers,
#   r.solver._last_inners)"
# (and mesh_n=4, mesh_nz=3)
LADDER_ANCHORS_F64 = {"2x2x2": (1.0284114215548106, 34, 369),
                      "4x4x3": (1.0289153873482633, 34, 728)}
# 6x6x4 at float64 (the first float64 solve of that size on an accelerator):
# within F64_F32_KEFF_TOL of the float32 ladder's k, outers +-3 of it, and
# |pcm| below the JAX package's IAEA-3D bound (VALIDATE's 2)
F64_F32_KEFF_TOL = 2e-5
IAEA3D_PCM_BOUND = 2.0
# the widest higher-order meshes the JAX package recorded (TPU float32, the
# JAX package's notes): order -> ((N, M), k, outers); k within WIDE_HO_KEFF_TOL,
# outers +-3, from the flat flux or one of four start fluxes perturbed by
# one float32 ulp (ACCEL_PERTURB_SEEDS), as [14a]
WIDE_HO = {1: ((8, 6), 1.0292915, 51), 2: ((6, 4), 1.0292895, 50)}
WIDE_HO_KEFF_TOL = 2e-5
# [20d]'s RT0 shapes: (mesh, float64): K1-K3 at float32 on the ladder's
# meshes new to the card, K1-K4 at float64 on 6x6x4
NEW_SHAPE_MESHES = (("4x4x3", False), ("8x8x6", False), ("6x6x4", True))
# the examples at float64, the card against the CPU: relative
EXAMPLE_REL_TOL = 1e-9
# but the subcritical example's k: its SolveKeff stops at tol_keff 1e-6 on a
# uniform 20 x 20 box, which amplifies rounding (the trap of small uniform
# boxes): on a CPU a 1e-15 change of the start flux alone moves that k by
# 2.2e-10 to 9.9e-9 relative (four seeds, float64), and the card and two
# CPUs read it up to 4.6e-9 apart; its M (the source iteration at
# tol_flux 1e-7) agrees to 1e-16
EXAMPLE_REL_TOL_ROUNDING = {("subcritical_source", "keff"): 5e-8}
# a float64 kernel against its plain version: relative to the contribution
# (FMA contraction in the kernel against the plain version's two roundings)
KERNEL_REL_TOL_F64 = 1e-12


def _new_shape_row(name, source, replaces, key, prefix, call, plain, base, tensors, flops,
                   card, launches, tol=KERNEL_REL_TOL, library=None):
    """One kernel at a shape a path of [20] gives it: the wrapper (``call``,
    which launches the kernel once: ``tracing``'s ``<prefix>.<key>`` moves by
    one) against
    its plain version relative to the contribution over ``base``, timed as
    [3] times it (CUDA events over 50 calls queued behind a sleep: device
    time), the plain version over 3 calls, the bound from ``tensors`` (the
    output appended) and ``flops``; ``launches``: the path's count.  Returns
    the row of the JSON line."""
    import torch

    from neutfem_tpu_torch import tracing

    # the first call's result is the one held to the plain version (a K1-K3
    # wrapper accumulates into its argument: later calls add to it again)
    before = tracing.total(f"{prefix}.{key}")
    got = call()
    torch.cuda.synchronize()
    if tracing.total(f"{prefix}.{key}") != before + 1:
        raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
    out = got[0] if isinstance(got, tuple) else got
    want = plain()
    want_out = want[0] if isinstance(want, tuple) else want
    err = _compare(name, out, want_out, base, tol)
    if isinstance(got, tuple):  # K8: the two dots too
        for what, g, w in (("<r,z>", got[1], want[1]), ("<r,r>", got[2], want[2])):
            rel = abs(float(g) - float(w)) / abs(float(w))
            if not rel <= tol:
                raise RuntimeError(f"{name}: {what} disagrees with the plain version ({rel:.2e})")
    ms = _timed(call, 50, queued=True)
    plain_ms = _timed(plain, 3)
    library_ms = _timed(library, 20) if library is not None else None
    bound = _bound((*tensors, out), flops,
                   F64_FLOP_PER_S if out.dtype == torch.float64 else F32_FLOP_PER_S)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + (f", library {library_ms:.4f} ms" if library_ms is not None else "")
          + f", bound {bound[0]:.4f} ms (share of bound {bound[0] / ms:.3f}); launches on its "
          f"path {launches} ({card})")
    row = _row(name, source, replaces, key, err, ms, plain_ms, bound, library_ms)
    row.pop("key")
    row.update(launches=launches, share_of_bound=bound[0] / ms, dtype=str(out.dtype))
    return row


def _rt0_rows(label, run, launches, card, rng, keys=("z", "y", "x"), k4=False):
    """K1-K3 (and with ``k4`` K4 at the three compute_current layouts) on
    one group's operands of ``run``'s context at its dtype, each against its
    plain version (``_new_shape_row``); ``launches``: the path's counts."""
    import torch

    from neutfem_tpu_torch.ops import fused, thomas
    from neutfem_tpu_torch.power import ctx_group

    fes, ctx = run.solver._fes, run.solver._ctx
    ctxg = ctx_group(ctx, 0)
    dt, dev = run.solver._dtype, ctxg["C"].device
    tol = KERNEL_REL_TOL_F64 if dt == torch.float64 else KERNEL_REL_TOL
    shape = (1, *fes.mesh.shape)
    v, acc0 = (torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=dev)
               for _ in range(2))
    dirs = {di.axis: di for di in fes.dirs}
    out = {}
    for key in keys:
        kid, wrapper, tag, axis = {"z": ("K1", fused.fused_schur_z, "", 0),
                                   "y": ("K2", fused.fused_schur_y_pre, "yT_", 1),
                                   "x": ("K3", fused.fused_schur_x_pre, "xT_", 2)}[key]
        di = dirs[axis]
        d = f"d{di.d}"
        dm, ll = ctxg[f"tri_{tag}dinvm_{d}"], ctxg[f"tri_{tag}l_{d}"]
        nat = (ctxg[f"tri_dinvm_{d}"], ctxg[f"tri_l_{d}"])
        c = (float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0]))
        scratch = acc0.clone()
        out[kid] = _new_shape_row(
            f"{kid} fused Schur direction {key} ({label} {tuple(fes.mesh.shape)}, {dt})",
            f"neutfem_tpu_torch/csrc/{'fused_z_rows.cu' if key == 'z' else 'fused_rows.cu'}",
            ROWS_REPLACES[key], f"{key}_rows", "fused",
            lambda: wrapper(scratch, v, dm, ll, *c),
            lambda: fused.fused_dir_plain(acc0, v, *nat, axis - 3, *c), acc0,
            (v, acc0, dm, ll), FUSED_FLOPS_PER_CELL * v.numel(), card,
            launches.get(f"{key}_rows", 0), tol)
    if k4:
        phi = torch.as_tensor(rng.standard_normal((run.spec.ng, *shape)), dtype=dt, device=dev)
        for di in sorted(fes.dirs, key=lambda di: -di.d):
            key = "zyx"[di.axis]
            r, dinv, lf, axis = _current_operands(fes, ctx, di, phi)
            out[f"K4 {key}"] = _new_shape_row(
                f"K4 batched Thomas solve, compute_current {key} ({label} {tuple(r.shape)}, {dt})",
                "neutfem_tpu_torch/csrc/thomas_rows.cu", K4_REPLACES[key], "thomas_rows",
                "thomas", lambda: thomas.thomas_solve(r, dinv, lf, axis),
                lambda: thomas.thomas_solve_plain(r, dinv, lf, axis), torch.zeros_like(r),
                (r, dinv, lf), THOMAS_FLOPS_PER_ELEMENT * r.numel(), card,
                launches.get("thomas_rows", 0), tol)
    return out


def _ho_rows(label, run, launches, card, rng):
    """K6 z / y / x and K8 on the fp8 E-form at one group's operands of
    ``run``'s RT_k-P_k context (float32), each against its plain version
    (``_new_shape_row``; K8's library time: the port's former default apply,
    ``power._block_precond`` on the float32 copy, plus the two dots, as in
    [3])."""
    import torch

    from neutfem_tpu_torch.ops import blockjac, fused_ho
    from neutfem_tpu_torch.power import _block_precond, ctx_group

    fes = run.solver._fes
    ctxg = ctx_group(run.solver._ctx, 0)
    dev, f32 = ctxg["C"].device, torch.float32
    k1 = run.rt_order + 1
    shape = (1, fes.P, *fes.mesh.shape)
    v, acc0 = (torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
               for _ in range(2))
    out = {}
    for key, wrapper, axis, tag in (("z", fused_ho.fused_ho_z, 0, None),
                                    ("y", fused_ho.fused_ho_y, 1, "hoyT"),
                                    ("x", fused_ho.fused_ho_x, 2, "hoxT")):
        di = [d for d in fes.dirs if d.axis == axis][0]
        d = f"d{di.d}"
        tabs = fused_ho.ho_tables(fes, di)
        natural = (ctxg[f"tri_dinvm_{d}"], ctxg[f"tri_l_{d}"], ctxg[f"alpha_{d}"])
        ops = natural if tag is None else tuple(ctxg[f"tri_{tag}_{n}_{d}"]
                                                for n in ("dinvm", "l", "alpha"))
        scratch = acc0.clone()
        # [3]'s operation count of K6 per (transverse mode, cell)
        flops = (v.numel() // k1) * (4 * k1 + 6 + k1 * (5 + 2 * k1))
        out[f"K6 {key}"] = _new_shape_row(
            f"K6 condensed Schur direction {key} ({label} {tuple(fes.mesh.shape)} P={fes.P})",
            "neutfem_tpu_torch/csrc/fused_ho_rows.cu", HO_REPLACES[key], f"ho_{key}_rows",
            "fused_ho", lambda: wrapper(scratch, v, *ops, tabs),
            lambda: fused_ho.fused_ho_plain(acc0, v, *natural, axis - 3, tabs), acc0,
            (v, acc0, *ops), flops, card, launches.get(f"ho_{key}_rows", 0))
    if run.rt_order == 2:  # K8 at the widest RT2-P2 blocks
        P = fes.P
        eform = ctxg["precond_blk_dev"]
        r = torch.as_tensor(rng.standard_normal((P, *fes.mesh.shape)), dtype=f32, device=dev)
        cells = r.numel() // P
        apply = _block_precond({"precond_blk_dev": eform}, f32)

        def library():
            zl = apply(r)
            return torch.sum(r * zl), torch.sum(r * r)

        out["K8"] = _new_shape_row(
            f"K8 block-Jacobi apply + dots ({label} {tuple(fes.mesh.shape)} P={P}, E-form blocks)",
            "neutfem_tpu_torch/csrc/blockjac_tiled.cu", "neutfem_tpu/ops/pallas_blockjac.py:114",
            "blockjac_dev", "blockjac", lambda: blockjac.blockjac_dev_dots(eform, r),
            lambda: blockjac.blockjac_dots_plain(eform, r, True), r, (eform, r),
            cells * (2 * P * P + P + 4 * P), card, launches.get("blockjac_dev", 0),
            library=library)
        del apply
    return out


def _last_entry_points(dev, card, reset_counts, counts, cg_line, rows):
    """Phase [20]: the scaling ladder at float32 and float64, the widest
    higher-order rows, the kernels at their shapes and the examples, each
    path with its own counts (module docstring).  Adds the kernel rows of
    (d) to ``rows``."""
    import numpy as np
    import torch

    from neutfem_tpu_torch import bench, scaling
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.examples import convergence_study, quickstart, subcritical_source
    from neutfem_tpu_torch.rounding_probe import perturbed_start

    f32, f64 = torch.float32, torch.float64
    spec = BENCHMARKS["iaea3d"]
    rng = np.random.default_rng(20)
    t_all = t0 = time.perf_counter()

    def launched(row, keys, what):
        got = {k: row["launches"].get(k, 0) for k in keys}
        if min(got.values()) <= 0:
            raise RuntimeError(f"{what}: launches {got}")
        return got

    # (a) the float32 ladder
    print("[20a] the scaling ladder: neutfem_tpu_torch.scaling.main([]), float32 at "
          "bench.FULL_TOL")
    reset_counts()
    ladder = scaling.main([])
    by_mesh = {r["mesh"]: r for r in ladder}
    for r in ladder:
        k_a = LADDER_ANCHORS_F32[r["mesh"]]
        tol = SCALE_KEFF_TOL if r["n_cells"] >= LADDER_WIDE_CELLS else KEFF_TOL
        keys = (*Z_KEYS, "thomas_rows")
        print(f"    {r['mesh']} ({r['n_cells']} cells): k {r['keff']} (anchor {k_a[0]}, tol {tol}), "
              f"pcm {r['pcm']:+.2f}, {r['outers']} / {r['inners']} (anchors {k_a[1:]}), "
              f"{1e3 * r['s_per_outer']:.3f} ms/outer, per doubling {r.get('per_doubling')}, "
              f"{r['preconditioner']}, peak {r['peak_mem_gb']} GB; launches "
              f"{launched(r, keys, '[20a] ' + r['mesh'])} ({card})")
        cg_line(r["cg"])
        _check_anchor(f"[20a] IAEA-3D {r['mesh']}", r["keff"], r["outers"], r["inners"], k_a, tol)
        want_pc = "line" if r["n_cells"] >= 3_000_000 else "jacobi"  # power.LINE_MIN_CELLS
        if r["preconditioner"] != want_pc:
            raise RuntimeError(f"[20a] {r['mesh']}: preconditioner {r['preconditioner']!r}")
        if want_pc == "line" and r["launches"].get("thomas_rows", 0) < r["inners"]:
            raise RuntimeError(f"[20a] {r['mesh']}: K4 not launched every CG iteration")
    print(f"    [20a] {time.perf_counter() - t0:.1f} s")

    # (b) the float64 ladder
    t0 = time.perf_counter()
    print("[20b] the scaling ladder at float64: neutfem_tpu_torch.scaling.main(['--x64', "
          "'--meshes', '2x2x2,4x4x3,6x6x4'])")
    reset_counts()
    ladder64 = scaling.main(["--x64", "--meshes", "2x2x2,4x4x3,6x6x4"])
    for r in ladder64:
        keys = (*Z_KEYS, "thomas_rows")
        print(f"    {r['mesh']} float64: k {r['keff_unrounded']!r}, pcm {r['pcm']:+.2f}, {r['outers']} / "
              f"{r['inners']}, {1e3 * r['s_per_outer']:.3f} ms/outer, peak {r['peak_mem_gb']} GB; "
              f"launches {launched(r, keys, '[20b] ' + r['mesh'])} ({card})")
        cg_line(r["cg"])
        if r["dtype"] != str(f64):
            raise RuntimeError(f"[20b] {r['mesh']}: dtype {r['dtype']}")
        if r["mesh"] in LADDER_ANCHORS_F64:
            k_a, o_a, i_a = LADDER_ANCHORS_F64[r["mesh"]]
            dk = abs(r["keff_unrounded"] - k_a)
            print(f"      against the JAX package's CPU float64 {k_a!r} / {o_a} / {i_a}: |dk| "
                  f"{dk:.2e}")
            if dk > 1e-9 or r["outers"] != o_a or abs(r["inners"] - i_a) > 2:
                raise RuntimeError(f"[20b] {r['mesh']}: off the JAX package's float64 solve")
        else:
            r32 = by_mesh[r["mesh"]]
            print(f"      against [20a]'s float32 {r32['keff']} / {r32['outers']}: dk "
                  f"{r['keff'] - r32['keff']:+.2e}; pcm {r['pcm']:+.2f} (bound "
                  f"{IAEA3D_PCM_BOUND})")
            if (abs(r["keff_unrounded"] - r32["keff_unrounded"]) > F64_F32_KEFF_TOL
                    or abs(r["pcm"]) >= IAEA3D_PCM_BOUND
                    or abs(r["outers"] - r32["outers"]) > OUTERS_TOL):
                raise RuntimeError(f"[20b] {r['mesh']} float64: off the float32 solve or k_ref")
    print(f"    [20b] {time.perf_counter() - t0:.1f} s")

    # (d), the RT0 part: K1-K3 at 4x4x3 and 8x8x6 on float32 operands, K1-K4
    # at float64 on 6x6x4's, each with its ladder row's launches
    t0 = time.perf_counter()
    print(f"[20d] kernels vs plain at the ladder's new shapes ({card})")
    by_mesh64 = {r["mesh"]: r for r in ladder64}
    for mesh, x64 in NEW_SHAPE_MESHES:
        n, _, nz = map(int, mesh.split("x"))
        dtype, src = (f64, by_mesh64) if x64 else (f32, by_mesh)
        run = bench.BenchmarkRun(spec, mesh_n=n, mesh_nz=nz, device=dev, dtype=dtype)
        for kid, row in _rt0_rows(f"IAEA-3D {mesh}", run, src[mesh]["launches"], card, rng,
                                  k4=x64).items():
            rows[f"{kid} {mesh} {str(dtype)[6:]}"] = row
        del run
    print(f"    [20d] RT0 {time.perf_counter() - t0:.1f} s")

    # (c) the widest higher-order rows, then (d)'s K6 / K8 rows on their operands
    for order, ((n, nz), k_a, o_a) in WIDE_HO.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = bench.BenchmarkRun(spec, mesh_n=n, mesh_nz=nz, device=dev, dtype=f32,
                                 rt_order=order)
        build = time.perf_counter() - t0
        s = run.solver
        print(f"[20c] RT{order}-P{order} {n}x{n}x{nz}: neutfem_tpu_torch.bench.main_ho({order}, "
              f"{n}, {nz}), float32 at bench.HO_TOL; {s._fes.n_phi} flux DOFs a group, "
              f"{s.GetNumElements()} cells; build {build:.1f} s (context {s.build_seconds})")
        reset_counts()
        res = bench.main_ho(order, n, nz, run=run)
        L = counts()
        det = res["detail"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
        print(f"    k {keff} (anchor {k_a}), {outers} outers (anchor {o_a}), {inners} inners; "
              f"{res['value'] * 1e3:.3f} ms/outer; block storage {det['block_precond']}; peak "
              f"{peak:.2f} GB ({card})")
        print(f"    launches {L}")
        cg_line(det["cg"])
        solves = [(keff, outers, inners)]
        if not abs(outers - o_a) <= OUTERS_TOL:
            for seed in ACCEL_PERTURB_SEEDS:
                s.reset_flux()
                perturbed_start(s, 1e-7, seed)
                solves.append((s.SolveKeff(), s._last_outers, s._last_inners))
            print(f"    off the anchor's outers; from perturbed start fluxes (k, outers, inners): "
                  f"{solves[1:]}")
        if any(abs(k - k_a) > WIDE_HO_KEFF_TOL for k, _, _ in solves):
            raise RuntimeError(f"[20c] RT{order}-P{order} {n}x{n}x{nz}: k {solves} not within "
                               f"{WIDE_HO_KEFF_TOL} of {k_a}")
        if not any(abs(o - o_a) <= OUTERS_TOL for _, o, _ in solves):
            raise RuntimeError(f"[20c] RT{order}-P{order} {n}x{n}x{nz}: no solve within "
                               f"{OUTERS_TOL} outers of {o_a}")
        if (any(L[k] <= 0 for k in HO_KEYS) or L["blockjac_dev"] < inners or L["thomas_rows"] <= 0
                or L["blockjac_tiled"]):
            raise RuntimeError(f"[20c] RT{order}-P{order} {n}x{n}x{nz}: K6 / K8 / K4 launches "
                               "off, or K8 ran on the inverse")
        for kid, row in _ho_rows(f"IAEA-3D {n}x{n}x{nz} RT{order}-P{order}", run, L, card,
                                 rng).items():
            rows[f"{kid} RT{order} {n}x{n}x{nz}"] = row
        del run, s
        torch.cuda.empty_cache()
        print(f"    [20c] RT{order} {time.perf_counter() - t0:.1f} s")

    # (e) the examples: float64, the card against the CPU; then the card's default once
    t0 = time.perf_counter()
    for name, mod in (("quickstart", quickstart), ("convergence_study", convergence_study),
                      ("subcritical_source", subcritical_source)):
        print(f"[20e] neutfem_tpu_torch.examples.{name}.main(), float64, cpu then cuda")
        cpu = mod.main(device="cpu", dtype=f64)
        reset_counts()
        gpu = mod.main(device="cuda", dtype=f64)
        L = {k: v for k, v in counts().items() if v}
        pairs = ([(f"{r['label']} k", g["keff"], r["keff"]) for g, r in zip(gpu, cpu)]
                 + [(f"{r['label']} outers", g["outers"], r["outers"]) for g, r in zip(gpu, cpu)]
                 if isinstance(cpu, list) else
                 [(k, gpu[k], cpu[k]) for k in cpu if k != "flux_shape"])
        rel = {what: abs(g - c) / abs(c) for what, g, c in pairs}
        off = {what: r for what, r in rel.items()
               if r > EXAMPLE_REL_TOL_ROUNDING.get((name, what), EXAMPLE_REL_TOL)}
        print(f"    cuda - cpu: largest relative difference {max(rel.values()):.2e} over "
              f"{len(pairs)} numbers ({rel}); launches {L}")
        if off or (isinstance(cpu, dict) and gpu.get("flux_shape") != cpu.get("flux_shape")):
            raise RuntimeError(f"[20e] {name}: the card disagrees with the CPU ({pairs})")
        if not any(k in L for k in (*Z_KEYS, "thomas_rows", "thomas_wide_rows")):
            raise RuntimeError(f"[20e] {name}: no kernel launched on the card")
        print(f"[20e] {name} at its default dtype on the card:")
        mod.main(device="cuda")
    print(f"    [20e] {time.perf_counter() - t0:.1f} s")
    print(f"    [20] {time.perf_counter() - t_all:.1f} s")


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
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.ops import cuda_lib
    from neutfem_tpu_torch.power import ctx_group

    reset_counts, counts = _reset_counts, _counts

    def cg_line(cg=None):
        """Print the CG counts of a path (``cg``: a bench row's timed solves,
        default every solve since ``reset_counts``) with its host reads per
        iteration, and check that every CG ran as graph replays, one host read
        a replay, at least one a solve and at most ceil(n / BLOCK_ITERS)."""
        cg = bench.cg_counts() if cg is None else cg
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
    if sys.argv[1:] == ["--phase", "15"]:  # phase [15] alone, for a change there: no result
        rows = {}
        _variant_paths(bench, dev, card, reset_counts, counts, rows)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"kernels": list(rows.values())}))
        return
    if sys.argv[1:] == ["--phase", "16"]:  # phase [16] alone: no result
        rows = {}
        _sharded_paths(bench, dev, card, rows)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"kernels": list(rows.values())}))
        return
    if sys.argv[1:] == ["--phase", "17"]:  # phase [17] alone: no result
        rows = {}
        _sharded_variants(bench, dev, card, rows)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"kernels": list(rows.values())}))
        return
    if sys.argv[1:] == ["--phase", "18"]:  # phase [18] alone: no result, no kernel rows
        _scan_cuts(bench, dev, card)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        return
    if sys.argv[1:] == ["--phase", "19"]:  # phase [19] alone: no result
        rows = {}
        _literature_paths(dev, card, reset_counts, counts, cg_line, rows)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"kernels": list(rows.values())}))
        return
    if sys.argv[1:] == ["--phase", "20"]:  # phase [20] alone: no result
        rows = {}
        _last_entry_points(dev, card, reset_counts, counts, cg_line, rows)
        print(f"    total {time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"kernels": list(rows.values())}))
        return
    spec = BENCHMARKS["iaea3d"]
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
    cg_rng = np.random.default_rng(80)  # leaves the phase's own operands as they were
    for label, n, rr in CG_STEP_SHAPES:
        rows[f"CG step {label}"] = _cg_step_case(label, n, rr, card, cg_rng)

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
    # of ce*y exceeds the contribution's tolerance; phases [4] and [12] run
    # the real ones.
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
    zrun = bench.BenchmarkRun(BENCHMARKS["zion2d"], mesh_n=48,
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
    krun = bench.BenchmarkRun(BENCHMARKS["koeberg2d"], mesh_n=32,
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
    # the tiled kernels a case launches on the GPU (compute_current's K4 in each)
    tiled = {"RT0-P0": (*Z_KEYS, "thomas_rows"), "RT1-P1": (*HO_KEYS, "thomas_rows"),
             "Jacobi sweep": ("z_batched_rows", *K5_KEYS, "thomas_rows"),
             "adjoint": (*Z_KEYS, "thomas_rows")}
    for case in ("RT0-P0", "RT1-P1", "Jacobi sweep", "adjoint"):
        small = {}
        for device in ("cpu", "cuda"):
            reset_counts()
            small[device] = _small_solve(bench, spec, device, case)
        launched = {k: counts()[k] for k in tiled[case]}
        print(f"[4] IAEA-3D 1x1 {case} float64: cuda {small['cuda']}  cpu {small['cpu']}"
              + (f"; launches {launched}" if launched else ""))
        if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
                or small["cuda"][1] != small["cpu"][1]
                or abs(small["cuda"][2] - small["cpu"][2]) > 2
                or any(launched[k] <= 0 for k in tiled[case])):
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
        reset_counts()
        small[device] = _small_2d_solve(bench, device)
    launched = {k: counts()[k] for k in ("y_rows", "x_rows")}
    print(f"[4] KOEBERG 4x4 float64: cuda {small['cuda']}  cpu {small['cpu']}; K2 / K3 launches "
          f"{launched}")
    if (abs(small["cuda"][0] - small["cpu"][0]) > 1e-9
            or small["cuda"][1] != small["cpu"][1]
            or abs(small["cuda"][2] - small["cpu"][2]) > 2
            or min(launched["y_rows"], launched["x_rows"]) < small["cuda"][2]):
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
    step = {k: launches[k] for k in ("cg_xr", "cg_p")}
    print(f"    CG step kernels (cgstep.cg_xr, cgstep.cg_p): {step}")
    if min(step.values()) <= 0:
        raise RuntimeError("main path: the CG step kernels (cg_xr, cg_p) did not launch")
    row = rows["CG step IAEA-3D 6x6x4"]
    row["launches"] = launches[row.pop("key")]
    det = res["detail"]
    keff, outers, inners = det["keff"], det["outer_iterations"], det["inner_iterations"]
    print(f"    keff {keff} (anchor {KEFF_ANCHOR}), outers {outers} ({OUTERS_ANCHOR}), "
          f"inners {inners} ({INNERS_ANCHOR}); {res['value'] * 1e3:.3f} ms/outer ({card})")
    _check_anchor("RT0-P0 6x6x4", keff, outers, inners,
                  (KEFF_ANCHOR, OUTERS_ANCHOR, INNERS_ANCHOR))
    keff_main = keff
    opt_in = (*(f"{k}_rows" for k in EQ_REPLACES), "blockjac_tiled", "blockjac_dev")
    if any(launches[k] for k in opt_in):
        raise RuntimeError("main path: an opt-in kernel (K7, K8) launched without its switch")
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
        for key in ("z", "y", "x"):
            row = ho_rows[order][key]
            row["launches"] = launches[row.pop("key")]
            rows[f"K6 {key}" + ("" if order == 2 else f" RT{order}")] = row
        if launches["blockjac_tiled"] != 0:
            raise RuntimeError(f"RT{order}-P{order}: blockjac_tiled launched "
                               f"{launches['blockjac_tiled']} times on the default path")
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
    if launches["thomas_rows"] < inners:
        raise RuntimeError(f"IAEA-3D 8x8x8: {launches['thomas_rows']} tiled z Thomas launches "
                           f"for {inners} CG iterations")
    rows["K4 8x8x8"]["launches"] = launches[rows["K4 8x8x8"].pop("key")]
    if any(launches[k] < inners for k in Z_KEYS):
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
    for key in Z_KEYS:
        if launches[key] != 0:
            raise RuntimeError(f"Jacobi sweep: the one-group kernel {key} launched "
                               f"{launches[key]} times")
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
    if any(launches[k] <= 0 for k in (*Z_KEYS, "thomas_rows")):
        raise RuntimeError("CMFD / coarse init: the tiled K1-K3 did not serve them")
    del run, s
    d2 = bench.BenchmarkRun(BENCHMARKS["iaea2d"], mesh_n=3,
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
    if launches["blockjac_tiled"] < inners or launches["blockjac_dev"]:
        raise RuntimeError(f"NEUTFEM_BLOCKJAC=1: K8 launched {launches['blockjac_tiled']} times "
                           f"(E-form {launches['blockjac_dev']}) for {inners} CG iterations")
    if any(launches[k] <= 0 for k in HO_KEYS):
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
    run = bench.BenchmarkRun(BENCHMARKS["zion2d"], mesh_n=48,
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
    if graph_l.get("thomas_wide_rows", 0) <= 0:
        raise RuntimeError("ZION line preconditioner: the tiled K4′ did not run in the graph")
    del run, s
    print(f"    [13] {time.perf_counter() - t0:.1f} s")

    # [14] the facade's surface: each part with its own counts
    _facade_paths(bench, spec, dev, card, reset_counts, counts, cg_line)

    # [15] the last single-device solver features: each row with its own counts
    t0 = time.perf_counter()
    _variant_paths(bench, dev, card, reset_counts, counts, rows)
    print(f"    [15] {time.perf_counter() - t0:.1f} s")

    # [16] the multi-device solve: each path with its own counts
    t0 = time.perf_counter()
    _sharded_paths(bench, dev, card, rows)
    print(f"    [16] {time.perf_counter() - t0:.1f} s")

    # [17] the solver variants under a sharding scope: each path with its own counts
    _sharded_variants(bench, dev, card, rows)

    # [18] the scan cut-axis solve: each path with its own counts
    _scan_cuts(bench, dev, card)

    # [19] the literature cores: each path with its own counts
    _literature_paths(dev, card, reset_counts, counts, cg_line, rows)

    # [20] the scaling ladder, the widest higher-order rows, the examples:
    # each path with its own counts
    _last_entry_points(dev, card, reset_counts, counts, cg_line, rows)
    print(f"    total {time.perf_counter() - t_all:.1f} s")

    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
