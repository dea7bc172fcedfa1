"""k-eff benchmarks on the PyTorch port (one JSON line each, as ``bench.py``).

Port of ``benchmarks/runner.BenchmarkRun`` (the full core and the quarter and
half domains with their mirror cut planes; ``solve`` with the JAX runner's
options, the adjoint and the assembly power factors), of ``bench.main``, of rows of
``bench.main_full`` and of ``benchmarks/accel_compare.run_matrix``:

* ``main``: IAEA-3D at NxN per assembly and M axial subdivisions per plane,
  RT0-P0, two groups; one warm-up solve, then three timed solves from a cold
  flux (``reset_flux`` before each), the median reported as seconds per outer
  iteration;
* ``main_ho``: IAEA-3D 4x4x2 at RT_k-P_k (k = 1, 2);
* ``main_2d``: the fine 2D cores, KOEBERG 32x32 (4 groups, upscatter; 544^2
  cells) and ZION 48x48 (912^2 cells), with the two-grid coarse level the
  facade attaches by default there;
* ``main_scale``: IAEA-3D 8x8x8 (3,511,808 cells), where "auto" picks the line
  preconditioner;
* ``main_2p6m``: IAEA-3D 8x8x6 (2,633,856 cells), below the line
  preconditioner's threshold: Jacobi;
* ``main_adjoint``: ``bench.py --full``'s IAEA-3D 6x6x4 free-running adjoint
  row: one direct solve, one adjoint solve, then one timed adjoint solve from
  a cold adjoint flux;
* ``main_sweep``: one IAEA-3D 6x6x4 power iteration with the Gauss-Seidel or
  the Jacobi group sweep (every group in one batched CG, no Chebyshev) at
  ``SWEEP_TOL``, through ``power.power_iteration``;
* ``main_optin``: the JAX package's opt-in switches against the default path
  in one process, solves in turns: at RT0-P0 6x6x4 ``NEUTFEM_EQFOLD=1|2`` (K7)
  and ``NEUTFEM_CGCG=1``; at RT_k-P_k 4x4x2 the default fp8 block storage
  (K8 on the E-form), the bfloat16 one (``NEUTFEM_BLKFP8=0``) and bfloat16 with ``NEUTFEM_BLOCKJAC=1``
  (K8);
* ``main_accel``: the accelerator matrix — IAEA-2D 8x8, KOEBERG 8x8 and
  IAEA-3D 6x6x4, each under "none", "chebyshev" and "anderson": one solve,
  then one timed solve from a cold flux; one JSON row each;
* ``main_variants``: the solver features outside the main path on IAEA-3D
  (``VARIANTS``): the diagonal and lumped A-solves, the elementwise
  bug-compat solve, the lateral faces PERIODIC (RT0 at 6x6x4, RT1-P1 at
  4x4x2) beside the mirrored quadrant, a subcritical solve driven by a
  NEUMANN inward current on the bottom face, BiCGSTAB beside the CG, and CMFD
  "wielandt"; one JSON row each;
* ``main_full``: ``bench.py --full``'s measured rows in its order (``main``,
  ``main_ho`` at both orders, ``main_2p6m``, ``main_scale``, ``main_2d`` at
  KOEBERG 32x32 and ZION 48x48, ``main_adjoint``), written to a JSON file
  only when given its path.  The JAX function's two rows of typed-in TPU
  constants are not measurements and are left out.

``main_ho``, ``main_2d``, ``main_2p6m`` and ``main_scale`` run as ``bench.py
--full`` does: one solve, ``reset_flux``, then one timed solve from a cold
flux.  The benchmark data come from the port's own copy,
``neutfem_tpu_torch/data.py``.

Run on a GPU with ``python -m neutfem_tpu_torch.bench [N [M]] [--order K |
--core {koeberg2d,zion2d} | --scale | --adjoint | --sweep {gs,jacobi} |
--accel [--json PATH] | --variants | --full [--json PATH]]``, or ``python -m
neutfem_tpu_torch.bench --optin [--order K]``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import tracing
from .compat import BCType, LinearSolverType, NeutFEM, VerbosityLevel
from .data import BENCHMARKS, sigr_of
from .mesh import boundary_attribute
from .power import power_iteration

__all__ = ["BenchmarkRun", "main", "main_ho", "main_2d", "main_scale", "main_2p6m",
           "main_adjoint", "main_sweep", "main_optin", "main_accel", "main_variants",
           "main_full", "cli", "env"]

#: Measured CPU cost of the reference algorithm (the scipy transcription in
#: tests/ref_replica.py), the same constant as bench.py's vs_baseline.
CPU_SECONDS_PER_CELL_PER_OUTER = 8.84e-6

#: ``bench.py``'s RT0 tolerances (k, flux, L2, outers, inners), its
#: ``--full`` rows' too.
FULL_TOL = (1e-5, 1e-4, 1e-4, 200, 1000)

def _expand_layout(rows, n):
    """Subdivide each layout cell into n x n mesh cells."""
    return np.array([[c for c in row for _ in range(n)] for row in rows
                     for _ in range(n)])


def _slice_domain(grid, domain):
    """The reference's domain conventions (iaea2d.py:136-151): quarter / half
    slicing.  Midpoints are taken on the y / x axes (the two last axes: in 3D
    the first axis is nz, which need not equal ny)."""
    hy = grid.shape[-2] // 2
    hx = grid.shape[-1] // 2
    m = {
        "quart_so": (slice(hy, None), slice(None, hx)),
        "quart_no": (slice(None, hy), slice(None, hx)),
        "quart_ne": (slice(None, hy), slice(hx, None)),
        "quart_se": (slice(hy, None), slice(hx, None)),
        "moitie_s": (slice(hy, None), slice(None, None)),
        "moitie_o": (slice(None, None), slice(None, hx)),
        "moitie_n": (slice(None, hy), slice(None, None)),
        "moitie_e": (slice(None, None), slice(hx, None)),
    }
    if domain in m:
        ys, xs = m[domain]
        return grid[..., ys, xs]
    return grid


#: The cut planes of each domain as (axis, upper) pairs, MIRROR there and
#: DIRICHLET elsewhere: the geometrically correct planes after the slicing
#: above (the reference drivers name TOP / RIGHT for quart_so, which their
#: no-op MIRROR hides; ``benchmarks/runner.py:110-135``).
CUTS = {
    "entier": (),
    "quart_so": ((1, False), (0, True)),
    "quart_no": ((1, True), (0, True)),
    "quart_ne": ((1, True), (0, False)),
    "quart_se": ((1, False), (0, False)),
    "moitie_s": ((1, False),),
    "moitie_n": ((1, True),),
    "moitie_o": ((0, True),),
    "moitie_e": ((0, False),),
}


class BenchmarkRun:
    """Holds the solver + results of one benchmark execution."""

    def __init__(self, spec, mesh_n: int = 2, mesh_nz: int = 1, domain: str = "entier",
                 verbose: bool = False, *, device="cuda", dtype=None, rt_order: int = 0,
                 p_order: Optional[int] = None, bc: Optional[dict] = None):
        if domain not in CUTS:
            raise ValueError(f"unsupported domain {domain!r}")
        self.spec = spec
        self.mesh_n = mesh_n
        self.mesh_nz = mesh_nz
        self.rt_order = int(rt_order)
        self.p_order = int(p_order) if p_order is not None else self.rt_order
        self.domain = domain
        self.verbose = verbose
        # (axis, upper) -> (BCType, value) set in place of the domain's rule
        self.bc = dict(bc or {})
        self.keff: Optional[float] = None
        self.keff_adj: Optional[float] = None
        self.Fass: Optional[np.ndarray] = None
        self.solve_seconds: Optional[float] = None
        self.outer_iterations: Optional[int] = None
        self._build(device, dtype)

    def _build(self, device, dtype):
        spec = self.spec
        n = self.mesh_n
        if spec.dim == 3:
            planes = [
                _expand_layout(p, n) for p in spec.layout3d for _ in range(self.mesh_nz)
            ]
            grid = _slice_domain(np.array(planes), self.domain)
            nz, ny, nx = grid.shape
            hz = spec.pitch_z / self.mesh_nz
            z_breaks = np.linspace(0.0, nz * hz, nz + 1)
        else:
            grid = _slice_domain(_expand_layout(spec.layout, n), self.domain)
            grid = grid[None]  # (1, ny, nx)
            nz, ny, nx = grid.shape
            z_breaks = np.array([0.0])
        self.grid = grid

        h = spec.pitch / n
        x_breaks = np.linspace(0.0, nx * h, nx + 1)
        y_breaks = np.linspace(0.0, ny * h, ny + 1)

        s = NeutFEM(self.rt_order, self.p_order, spec.ng, x_breaks, y_breaks, z_breaks,
                    device=device, dtype=dtype)
        s.set_verbosity(VerbosityLevel.NORMAL if self.verbose else VerbosityLevel.SILENT)
        s.set_linear_solver(LinearSolverType.BICGSTAB)
        cut = set(CUTS[self.domain])
        if self.domain.startswith("quart"):
            s.apply_quarter_rotational_symmetry(0, 1)
        for axis in range(spec.dim):  # vacuum (Marshak) on every face but the cuts
            for upper in (False, True):
                kind = BCType.MIRROR if (axis, upper) in cut else BCType.DIRICHLET
                kind, value = self.bc.get((axis, upper), (kind, 0.0))
                s.set_bc(boundary_attribute(spec.dim, axis, upper), kind, value)
        self._fill_xs(s)
        s.BuildMatrices()
        self.solver = s

    def _baffle_mask(self, grid):
        """ZION: the empty cells within one baffle thickness of fuel, (nz, ny, nx)
        bool — the JAX runner's per-cell search over the (2r+1)^2 square of
        neighbours (zion2d.py:265-303) as a square dilation of the fuel mask,
        separable into one pass per in-plane axis."""
        _, thick, fuel_chars = self.spec.baffle
        r = max(1, int(np.ceil(thick / (self.spec.pitch / self.mesh_n))))
        near = np.isin(grid, list(fuel_chars))
        for ax in (1, 2):
            n = grid.shape[ax]
            padded = np.pad(near, [(r, r) if a == ax else (0, 0) for a in range(3)])
            near = np.zeros_like(near)
            for s in range(2 * r + 1):
                near |= np.take(padded, np.arange(s, s + n), axis=ax)
        return (grid == ".") & near

    def _fill_xs(self, s: NeutFEM):
        """Per-cell cross sections, vectorized by material (the arrays equal the
        JAX runner's per-cell loop)."""
        spec = self.spec
        ng = spec.ng
        grid = self.grid

        D = np.zeros((ng, *grid.shape))
        SigR = np.zeros_like(D)
        NSF = np.zeros_like(D)
        Chi = np.zeros_like(D)
        SigS = np.zeros((ng, ng, *grid.shape))

        def put(sel, mat):
            D[:, sel] = np.array(mat["D"])[:, None]
            SigR[:, sel] = np.array(sigr_of(mat, ng))[:, None]
            NSF[:, sel] = np.array(mat["NSF"])[:, None]
            Chi[:, sel] = np.array(mat["CHI"])[:, None]
            for (gt, gf), v in mat["S"].items():
                SigS[gt, gf, sel] = v

        for ch in np.unique(grid):
            sel = grid == ch
            if ch != "." or spec.baffle is None:
                put(sel, spec.materials[ch] if ch != "." else spec.background)
                continue
            baffle = self._baffle_mask(grid)  # ZION: steel baffle, else water
            put(baffle, spec.baffle[0])
            put(sel & ~baffle, spec.background)

        def sq(a):
            return a[..., 0, :, :] if spec.dim == 2 else a

        s.get_D()[:] = sq(D)
        s.get_SigR()[:] = sq(SigR)
        s.get_NSF()[:] = sq(NSF)
        s.get_Chi()[:] = sq(Chi)
        s.get_SigS()[:] = sq(SigS)
        s.get_KSF()[:] = sq(NSF)  # power proxy

    def solve(self, tol=FULL_TOL, use_coarse_init: bool = False, coarse_factors=(),
              adjoint: bool = False, use_cmfd: bool = False,
              use_diagonal_solver: bool = False):
        """``SolveKeff`` at ``tol`` with the JAX runner's options, then the
        adjoint at the direct k (``adjoint``) and the assembly power factors;
        returns k.  ``solve_seconds`` times the direct solve alone."""
        s = self.solver
        s.set_tol(*tol)
        t0 = time.time()
        self.keff = s.SolveKeff(use_coarse_init=use_coarse_init,
                                coarse_factors=list(coarse_factors),
                                use_diagonal_solver=use_diagonal_solver, use_cmfd=use_cmfd)
        self.solve_seconds = time.time() - t0
        self.outer_iterations = s._last_outers
        if adjoint:
            self.keff_adj = s.SolveAdjoint()
        self._power_factors()
        return self.keff

    @property
    def pcm(self) -> float:
        """Reactivity deviation vs k_ref: 1e5 (1/k_ref - 1/k) (iaea2d.py:389)."""
        return 1e5 * (1.0 / self.spec.kref - 1.0 / self.keff)

    def _power_factors(self):
        """Assembly power factors ``Fass`` normalized to the number of fuel
        assemblies (iaea2d.py:406-420); set on a 2D full core only."""
        if self.spec.dim != 2 or self.domain != "entier":
            return
        s = self.solver
        pvol = (s.get_NSF() * s.get_flux()).sum(axis=0)  # (ny, nx)
        n = self.mesh_n
        na = pvol.shape[0] // n
        fass = pvol.reshape(na, n, na, n).sum(axis=(1, 3))
        total = fass.sum()
        if self.spec.n_fuel_assemblies and total > 0:
            fass = self.spec.n_fuel_assemblies * fass / total
        self.Fass = fass

    def power_deviation(self, reference_map: np.ndarray) -> np.ndarray:
        """% deviation of the assembly power factors from a reference table
        (the reference scripts' check_Ffaisc)."""
        return 100.0 * (reference_map - self.Fass) / reference_map


#: The CG counters a row reports under ``detail["cg"]``: ``tracing``'s
#: ``cg.<key>``.
CG_KEYS = ("solves", "iterations", "host_reads", "replays", "captures", "eager_solves")
#: The prefixes of ``tracing``'s launch counters (the kernel modules, the cut
#: direction's face solves, the collectives), which a row reports under their
#: bare keys ("z_rows", "thomas_rows", "collectives", ...).
LAUNCH_PREFIXES = ("fused", "thomas", "fused_ho", "fused_eq", "blockjac", "cgstep", "parttri",
                   "comm")


def reset_cg_counts() -> None:
    """Zero the ``cg.*`` counters (``cg.iterations_run`` too)."""
    tracing.reset_totals([f"cg.{k}" for k in CG_KEYS] + ["cg.iterations_run"])


def cg_counts() -> dict:
    """The ``cg.*`` counters' totals under ``CG_KEYS``."""
    return {k: tracing.total(f"cg.{k}") for k in CG_KEYS}


def launch_counts() -> dict:
    """Every launch counter's total so far, under its bare key."""
    return {name.partition(".")[2]: n for name, n in tracing.totals().items()
            if name.partition(".")[0] in LAUNCH_PREFIXES}


def _cg_detail() -> dict:
    """The CG counts of the timed solve(s) (``cg_counts``, reset just
    before them) and host reads per CG iteration."""
    st = cg_counts()
    st["host_reads_per_iteration"] = round(st["host_reads"] / max(st["iterations"], 1), 4)
    return st


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def main(mesh_n: int = 6, mesh_nz: int = 4, device="cuda", dtype=torch.float32) -> dict:
    """IAEA-3D solve timing; prints one JSON line and returns it as a dict.

    The default device is the GPU: a measurement that finds no card fails.
    The default dtype is float32, the benchmark path of the JAX package too."""
    spec = BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main: no CUDA device available")
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False,
                       device=device, dtype=dtype)
    n_cells = run.solver.GetNumElements()

    # solve 1 is a warm-up; then three timed solves from a cold flux, median
    run.solve(tol=FULL_TOL)
    walls = []
    reset_cg_counts()
    for _ in range(3):
        run.solver.reset_flux()
        t0 = time.time()
        keff = run.solver.SolveKeff()  # ends in a device -> host read of k
        walls.append(time.time() - t0)
    wall = float(np.median(walls))
    run.keff = keff

    outers = run.solver._last_outers
    inners = run.solver._last_inners
    pcm = 1e5 * (1.0 / spec.kref - 1.0 / keff)
    per_outer = wall / max(outers or 1, 1)
    # _last_inners sums per-group CG iterations; each touches one group's n_phi DOFs
    dofs_per_s = run.solver._fes.n_phi * inners / wall
    baseline_per_outer = CPU_SECONDS_PER_CELL_PER_OUTER * n_cells
    out = {
        "metric": "iaea3d_seconds_per_outer_iteration",
        "value": round(per_outer, 6),
        "unit": "s/outer",
        "vs_baseline": round(baseline_per_outer / per_outer, 3),
        "detail": {
            "keff": round(keff, 6),
            "kref": spec.kref,
            "pcm": round(pcm, 2),
            "n_cells": n_cells,
            "outer_iterations": outers,
            "inner_iterations": inners,
            "schur_cg_dofs_per_s": round(dofs_per_s, 1),
            "solve_wall_s": round(wall, 3),
            "solve_walls_3x_s": [round(w, 3) for w in walls],
            "cg": _cg_detail(),
            "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
            "device": _device_name(device),
            "dtype": str(run.solver._dtype),
        },
    }
    print(json.dumps(out))
    return out


#: The JAX package's higher-order rows (bench.py main_full): IAEA-3D 4x4x2.
HO_TOL = (1e-7, 1e-5, 1e-5, 120, 1000)


def main_ho(order: int, mesh_n: int = 4, mesh_nz: int = 2, device="cuda",
            dtype=torch.float32, run: Optional[BenchmarkRun] = None) -> dict:
    """IAEA-3D RT_k-P_k solve timing (k = ``order``); prints one JSON line with
    the JAX package's metric name and detail keys and returns it as a dict.

    As ``bench.py --full``: one solve, ``reset_flux``, then one timed solve from
    a cold flux.  ``run`` reuses a built benchmark of this order and mesh (its
    start flux as it stands: flat after a build or ``reset_flux``).  A
    measurement that finds no card fails."""
    spec = BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_ho: no CUDA device available")
    if run is None:
        run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False,
                           device=device, dtype=dtype, rt_order=order)
    elif (run.rt_order, run.mesh_n, run.mesh_nz) != (order, mesh_n, mesh_nz):
        raise ValueError(f"bench.main_ho: the run is RT{run.rt_order} at {run.mesh_n}x"
                         f"{run.mesh_n}x{run.mesh_nz}, not RT{order} at {mesh_n}x{mesh_n}x"
                         f"{mesh_nz}")
    run.solve(tol=HO_TOL)
    run.solver.reset_flux()
    reset_cg_counts()
    t0 = time.time()
    keff = run.solver.SolveKeff()  # ends in a device -> host read of k
    wall = time.time() - t0
    outers = run.solver._last_outers
    detail = {"keff": round(keff, 7), "n_dofs": int(run.solver._fes.n_phi),
              "outer_iterations": outers, "inner_iterations": run.solver._last_inners,
              "converged_not_capped": bool(outers < HO_TOL[3])}
    if order == 1:
        hist = run.solver.get_iteration_history()
        detail["final_dphi"] = float(hist[-1, 2]) if len(hist) else None
    # how the context stores the block inverse (NEUTFEM_BLKFP8, ops/context.py)
    detail["block_precond"] = {k: str(v.dtype) for k, v in run.solver._ctx.items()
                               if k.startswith("precond_blk")}
    detail.update({
        "solve_wall_s": round(wall, 3), "cg": _cg_detail(),
        "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz} RT{order}-P{order}",
        "device": _device_name(device),
        "dtype": str(run.solver._dtype),
    })
    out = {"metric": f"iaea3d_rt{order}p{order}_seconds_per_outer_iteration",
           "value": round(wall / max(outers, 1), 6), "unit": "s/outer", "detail": detail}
    print(json.dumps(out))
    return out


#: The JAX package's fine 2D rows: core -> metric name.
CORES_2D = {"koeberg2d": "koeberg2d_4group_seconds_per_outer_iteration",
            "zion2d": "zion2d_seconds_per_outer_iteration"}


def _launches_since(before: dict) -> dict:
    """The kernels launched since the counts ``before``, with their launches."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


def _timed_run(spec, what: str, device, dtype, **kwargs):
    """Build, solve once, ``reset_flux``, then one timed solve from a cold flux
    (``bench.py --full``).  Returns (run, keff, wall seconds, the kernel
    launches of the timed solve)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bench.{what}: no CUDA device available")
    run = BenchmarkRun(spec, verbose=False, device=device, dtype=dtype, **kwargs)
    run.solve(tol=FULL_TOL)
    run.solver.reset_flux()
    reset_cg_counts()
    before = launch_counts()
    t0 = time.time()
    keff = run.solver.SolveKeff()  # ends in a device -> host read of k
    wall = time.time() - t0
    return run, keff, wall, _launches_since(before)


def main_2d(core: str, mesh_n: int, device="cuda", dtype=torch.float32) -> dict:
    """A fine 2D core's solve timing (``core`` in ``CORES_2D``); prints one JSON
    line with the JAX row's metric name and detail keys, plus the device, the
    dtype and the preconditioner the group solves ran, and returns it."""
    spec = BENCHMARKS[core]
    run, keff, wall, _ = _timed_run(spec, "main_2d", device, dtype, mesh_n=mesh_n)
    s = run.solver
    outers = s._last_outers
    out = {
        "metric": CORES_2D[core],
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff": round(keff, 7),
            "pcm": round(1e5 * (1.0 / spec.kref - 1.0 / keff), 2),
            "n_cells": s.GetNumElements(), "n_groups": spec.ng,
            "outer_iterations": outers,
            "inner_iterations": s._last_inners,
            "solve_wall_s": round(wall, 3), "cg": _cg_detail(), "mesh": f"{mesh_n}x{mesh_n}",
            "device": _device_name(s._device), "dtype": str(s._dtype),
            "preconditioner": s.preconditioner(),
        },
    }
    print(json.dumps(out))
    return out


def _scale_row(metric: str, what: str, mesh_n: int, mesh_nz: int, device, dtype) -> dict:
    """One IAEA-3D RT0-P0 row of ``bench.py --full``'s scale rows at NxNxM:
    ``_timed_run``, then the JAX row's detail keys (less the TPU's
    ``axis_perm``) plus the CG counts, the device, the dtype and the
    preconditioner "auto" resolved to; prints one JSON line and returns it."""
    spec = BENCHMARKS["iaea3d"]
    run, keff, wall, _ = _timed_run(spec, what, device, dtype, mesh_n=mesh_n, mesh_nz=mesh_nz)
    s = run.solver
    outers = s._last_outers
    out = {
        "metric": metric,
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff": round(keff, 7),
            "pcm": round(1e5 * (1.0 / spec.kref - 1.0 / keff), 2),
            "n_cells": s.GetNumElements(),
            "outer_iterations": outers,
            "inner_iterations": s._last_inners,
            "solve_wall_s": round(wall, 3), "cg": _cg_detail(),
            "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
            "device": _device_name(s._device), "dtype": str(s._dtype),
            "preconditioner": s.preconditioner(),
        },
    }
    print(json.dumps(out))
    return out


def main_scale(device="cuda", dtype=torch.float32) -> dict:
    """IAEA-3D 8x8x8 (3.5M cells) solve timing, the JAX package's
    ``iaea3d_3p5M`` row; prints one JSON line and returns it."""
    return _scale_row("iaea3d_3p5M_seconds_per_outer_iteration", "main_scale", 8, 8, device,
                      dtype)


def main_2p6m(mesh_n: int = 8, mesh_nz: int = 6, device="cuda", dtype=torch.float32) -> dict:
    """IAEA-3D 8x8x6 (2.6M cells) solve timing, the JAX package's
    ``iaea3d_2p6M`` row (``bench.py:119``); prints one JSON line and returns
    it.  The mesh is kept in its own axis order: the TPU's axis relabelling
    (``mesh.best_axis_order``, the row's ``axis_perm``) is not ported."""
    return _scale_row("iaea3d_2p6M_seconds_per_outer_iteration", "main_2p6m", mesh_n, mesh_nz,
                      device, dtype)


def main_adjoint(mesh_n: int = 6, mesh_nz: int = 4, device="cuda", dtype=torch.float32) -> dict:
    """``bench.py --full``'s IAEA-3D free-running adjoint row: a direct solve,
    one adjoint solve, then one timed adjoint solve from a cold adjoint flux
    (free-running, so it also checks k-adjoint against k-direct); prints one
    JSON line with the JAX row's metric name and detail keys, plus the device
    and the dtype, and returns it."""
    spec = BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_adjoint: no CUDA device available")
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False, device=device,
                       dtype=dtype)
    k_direct = run.solve(tol=FULL_TOL)
    s = run.solver
    s.SolveAdjoint(use_direct_keff=False)
    s._phi_adj = None  # cold adjoint flux
    reset_cg_counts()
    t0 = time.time()
    k_adj = s.SolveAdjoint(use_direct_keff=False)  # ends in device -> host reads
    wall = time.time() - t0
    hist = s.get_iteration_history()
    outers = len(hist)
    out = {
        "metric": "iaea3d_adjoint_seconds_per_outer_iteration",
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff_adjoint": round(k_adj, 7), "keff_direct": round(k_direct, 7),
            "adjoint_vs_direct_pcm": round(1e5 * abs(1.0 / k_direct - 1.0 / k_adj), 3),
            "n_cells": s.GetNumElements(),
            "outer_iterations": outers,
            "inner_iterations": int(np.sum(hist[:, 3])),
            "solve_wall_s": round(wall, 3), "cg": _cg_detail(),
            "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
            "device": _device_name(s._device), "dtype": str(s._dtype),
        },
    }
    print(json.dumps(out))
    return out


#: Tolerances of ``main_sweep`` (k, flux, L2, outers, inners): the Jacobi sweep
#: runs without Chebyshev, and at ``FULL_TOL``'s 1e-5 / 1e-4 its slow
#: convergence stops it ~1.7e-4 short of the fixed point (IAEA-3D 1x1,
#: float64, on a CPU); at 1e-6 / 1e-5 it lands within 1e-5 of the Gauss-Seidel
#: k at the same tolerances.  600 outers: ``benchmarks/accel_compare.py``'s cap.
SWEEP_TOL = (1e-6, 1e-5, 1e-5, 600, 1000)


def main_sweep(sweep: str = "jacobi", mesh_n: int = 6, mesh_nz: int = 4, device="cuda",
               dtype=torch.float32, run: Optional[BenchmarkRun] = None) -> dict:
    """One IAEA-3D power iteration at ``SWEEP_TOL`` with the ``sweep`` group
    sweep ("gs": Gauss-Seidel with Chebyshev, "jacobi": every group in one
    batched CG), from a flat flux, through ``power.power_iteration`` with the
    facade's other settings; prints one JSON line and returns it.  ``run``
    reuses a built benchmark."""
    spec = BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_sweep: no CUDA device available")
    if run is None:
        run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False, device=device,
                           dtype=dtype)
    s = run.solver
    s.set_tol(*SWEEP_TOL)
    opts = dataclasses.replace(s._opts(), sweep=sweep)
    if s._device.type == "cuda":
        torch.cuda.synchronize(s._device)
    reset_cg_counts()
    t0 = time.time()
    res = power_iteration(s._fes, s._ng, opts, s._ctx, s._flat_phi(), 1.0)
    keff = float(res["keff"])  # a device -> host read
    wall = time.time() - t0
    outers = res["outer_iterations"]
    out = {
        "metric": f"iaea3d_{sweep}_sweep_seconds_per_outer_iteration",
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff": round(keff, 7), "n_cells": s.GetNumElements(),
            "outer_iterations": outers, "inner_iterations": res["inner_iterations"],
            "converged_not_capped": bool(outers < SWEEP_TOL[3]),
            "solve_wall_s": round(wall, 3), "cg": _cg_detail(),
            "mesh": f"{run.mesh_n}x{run.mesh_n}x{run.mesh_nz}",
            "device": _device_name(s._device), "dtype": str(s._dtype),
        },
    }
    print(json.dumps(out))
    return out


#: ``benchmarks/accel_compare.py``'s matrix: (core, BenchmarkRun keywords,
#: tolerances), each under every accelerator of ``ACCELS``.
ACCEL_CONFIGS = (
    ("iaea2d", dict(mesh_n=8), (1e-6, 1e-5, 1e-5, 600, 1000)),
    ("koeberg2d", dict(mesh_n=8), (1e-6, 1e-5, 1e-5, 600, 1000)),
    ("iaea3d", dict(mesh_n=6, mesh_nz=4), (1e-5, 1e-4, 1e-4, 600, 1000)),
)
ACCELS = ("none", "chebyshev", "anderson")


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (its first line), or the device's name
    off the card."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main_accel(configs=ACCEL_CONFIGS, accels=ACCELS, device="cuda",
               dtype=torch.float32, json_path: Optional[str] = None) -> list:
    """The accelerator matrix (``benchmarks/accel_compare.run_matrix``): for
    each configuration and accelerator one solve, then one timed solve from a
    cold flux; prints one JSON row each (k, outers, inners, wall, ms/outer,
    the CG counts, the kernel launches of the timed solve and the card's name
    and power limit) and returns the rows.  Asserts the accelerators reach
    the same fixed point: their k spread below 3 tol_keff.  ``json_path``:
    the rows are also written there as one JSON list (``accel_compare.py
    --json``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_accel: no CUDA device available")
    card = card_line(device)
    rows = []
    for name, kwargs, tol in configs:
        run = BenchmarkRun(BENCHMARKS[name], verbose=False, device=device, dtype=dtype,
                           **kwargs)
        s = run.solver
        s.set_tol(*tol)
        keffs = {}
        for accel in accels:
            s.set_acceleration(accel)
            s.reset_flux()
            s.SolveKeff()
            s.reset_flux()
            reset_cg_counts()
            before = launch_counts()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.time()
            keff = s.SolveKeff()  # ends in a device -> host read of k
            wall = time.time() - t0
            launches = _launches_since(before)
            keffs[accel] = keff
            rows.append({
                "core": name, "mesh": "x".join(str(v) for v in kwargs.values()),
                "n_cells": s.GetNumElements(), "accel": accel, "keff": round(keff, 7),
                "outer_iterations": s._last_outers, "inner_iterations": s._last_inners,
                "wall_s": round(wall, 4),
                "ms_per_outer": round(1e3 * wall / max(s._last_outers, 1), 4),
                "cg": _cg_detail(), "launches": launches,
                "dtype": str(dtype), "device": card,
            })
            print(json.dumps(rows[-1]), flush=True)
        spread = max(keffs.values()) - min(keffs.values())
        # each accelerator stops when |dk| < tol_keff, so two converged solves
        # may sit up to a few tol_keff apart around the fixed point
        if not spread < 3.0 * tol[0]:
            raise RuntimeError(f"{name}: accelerators disagree by {spread} (tol_keff {tol[0]})")
        del run, s
    if json_path:
        _write_json(json_path, rows)
    return rows


def _write_json(path: str, rows) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


#: ``main_variants``' rows: the diagonal A-solve (``SolveKeff(
#: use_diagonal_solver=True)``), the lumped one (``power_iteration`` on the
#: "lumped" context), the elementwise bug-compat solve, the four lateral
#: faces PERIODIC and the quadrant (``quart_so``) with all four MIRROR, at
#: RT0 (``mesh``) and at RT1-P1 (``ho_mesh``), a subcritical solve (nu-Sigma_f
#: x 0.9, no volume source) driven by a unit inward current on the bottom
#: face (NEUMANN), BiCGSTAB and the CG, and CMFD "wielandt"
VARIANTS = ("diag", "lumped", "diag_elementwise", "periodic", "periodic_mirror",
            "periodic_rt1", "periodic_rt1_mirror", "neumann", "bicgstab", "cg", "wielandt")
#: the tolerances of each row: the rows held to another row's k at
#: ``SWEEP_TOL``, the anchored ones at ``FULL_TOL``; CMFD "wielandt" stops
#: after 3 outers (one correction) of at most 10 low-order outers: its
#: low-order eigensolve walks off on IAEA-3D, in the JAX package too, at up
#: to 60 BiCGSTAB solves a correction by default (6.7 s an outer at 6x6x4
#: float32 on an NVIDIA H100)
VARIANT_TOL = {"diag": FULL_TOL, "lumped": FULL_TOL, "diag_elementwise": FULL_TOL,
               "wielandt": SWEEP_TOL[:3] + (3, SWEEP_TOL[4])}
#: the lateral faces (axis, upper) of a 3D core, PERIODIC or MIRROR
LATERAL = ((0, False), (0, True), (1, False), (1, True))


def _variant_setup(row: str, spec, mesh, ho_mesh, device, dtype):
    """(facade, solve) of one ``main_variants`` row: ``solve()`` runs the
    row's solve from a cold flux and returns (k or M, outers, inners,
    extra detail)."""
    order = 1 if row.startswith("periodic_rt1") else 0
    n, nz = ho_mesh if order else mesh
    kw = dict(mesh_n=n, mesh_nz=nz, verbose=False, device=device, dtype=dtype, rt_order=order)
    if row.startswith("periodic"):
        mirror = row.endswith("_mirror")
        kw["bc"] = {f: (BCType.MIRROR if mirror else BCType.PERIODIC, 0.0) for f in LATERAL}
        if mirror:
            kw["domain"] = "quart_so"
    elif row == "neumann":
        kw["bc"] = {(2, False): (BCType.NEUMANN, 1.0)}
    run = BenchmarkRun(spec, **kw)
    s = run.solver
    s.set_tol(*VARIANT_TOL.get(row, SWEEP_TOL))
    if row == "neumann":
        s.get_NSF()[...] *= 0.9
        s.BuildMatrices()

    def facade(**solve_kw):
        def solve():
            s.reset_flux()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                k = s.SolveKeff(**solve_kw)
            return k, s._last_outers, s._last_inners, {
                "warnings": [str(w.message)[:80] for w in caught]}
        return solve

    def direct(**opt_kw):
        def solve():
            opts = dataclasses.replace(s._opts(), **opt_kw)
            res = power_iteration(s._fes, s._ng, opts, s._context(opts.a_mode), s._flat_phi(),
                                  1.0)
            s._phi = res["phi"]
            return float(res["keff"]), res["outer_iterations"], res["inner_iterations"], {}
        return solve

    def subcritical():
        s.reset_flux()
        m = s.SolveSubcritical()
        # the bottom face's physical current, every group and cell: the lift
        # makes it the prescribed inward current
        ctx = s._context()
        j0 = (s._J["d2"]["face"][..., 0] * ctx["jscale_d2"])[:, 0]
        jmin, jmax = torch.aminmax(j0)
        return m, sum(s.subcritical_outers), None, {
            "bottom_current_min": float(jmin), "bottom_current_max": float(jmax),
            "outers_with_without_fission": list(s.subcritical_outers)}

    solve = {"diag": facade(use_diagonal_solver=True),
             "diag_elementwise": facade(use_diagonal_solver=True, diag_elementwise=True),
             "lumped": direct(a_mode="lumped"),
             "neumann": subcritical,
             "bicgstab": direct(inner_solver="bicgstab"),
             "cg": direct(),
             "wielandt": direct(use_cmfd=True, cmfd_mode="wielandt",
                                cmfd_lo_outers=10)}.get(row, facade())
    return run, s, solve


def main_variants(rows=VARIANTS, mesh=(6, 4), ho_mesh=(4, 2), device="cuda",
                  dtype=torch.float32, warmup: bool = True) -> list:
    """The solver features outside the main path (``VARIANTS``) on IAEA-3D at
    ``mesh`` (RT1-P1 rows at ``ho_mesh``): for each row one solve (without
    ``warmup``, none: the timed solve then includes building its CG plans
    and capturing their graphs), then one timed solve from a cold flux;
    prints one JSON row each (k, or M for
    "neumann", outers, inners, ms/outer, the CG counts, the kernel launches
    of the timed solve and the card's name and power limit) in
    ``bench.main``'s form and returns the rows.  ``device="cpu"`` runs them
    through the plain versions (small meshes only)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_variants: no CUDA device available")
    card = card_line(device)
    spec = BENCHMARKS["iaea3d"]
    out = []
    for row in rows:
        run, s, solve = _variant_setup(row, spec, mesh, ho_mesh, device, dtype)
        if warmup:
            solve()
        reset_cg_counts()
        before = launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        value, outers, inners, extra = solve()  # each ends in a device -> host read
        wall = time.time() - t0
        launches = _launches_since(before)
        detail = {"amplification" if row == "neumann" else "keff": value,
                  "outer_iterations": outers, "inner_iterations": inners,
                  "n_cells": s.GetNumElements(), "solve_wall_s": round(wall, 4),
                  "ms_per_outer": 1e3 * wall / max(outers, 1), "cg": _cg_detail(),
                  "launches": launches, "warm": warmup, **extra,
                  "mesh": f"{run.mesh_n}x{run.mesh_n}x{run.mesh_nz} {run.domain} "
                          f"RT{run.rt_order}-P{run.p_order}",
                  "device": card, "dtype": str(dtype)}
        out.append({"metric": f"iaea3d_{row}_seconds_per_outer_iteration",
                    "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
                    "row": row, "detail": detail})
        print(json.dumps(out[-1]), flush=True)
        del run, s, solve
    return out


@contextlib.contextmanager
def env(**switches):
    """Set environment switches (``NEUTFEM_EQFOLD="1"``, ...) for the block and
    restore the previous environment after it."""
    saved = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main_optin(order: int = 0, rounds: int = 7, device="cuda", dtype=torch.float32) -> dict:
    """The opt-in paths against the default path, in one process: after one
    untimed solve of each, ``rounds`` rounds of one timed cold-flux solve per
    variant, in turns (the order reversed every other round); prints one JSON
    line with each variant's ms/outer (all rounds and the median), k, outers
    and inners, and returns it.

    RT0-P0 (``order`` 0), IAEA-3D 6x6x4 at ``FULL_TOL``, one context built
    under ``NEUTFEM_EQFOLD`` (so it holds the eq operands; the other variants
    do not read them): the default matvec, ``NEUTFEM_EQFOLD=1``, ``=2`` and
    ``NEUTFEM_CGCG=1``.  RT_k-P_k (``order`` k), IAEA-3D 4x4x2 at ``HO_TOL``:
    the default fp8 block storage (applied by K8's E-form entry), and one
    context under ``NEUTFEM_BLKFP8=0``
    (bfloat16 blocks) solved with the default apply (``torch.bmm`` on a
    float32 copy) and with ``NEUTFEM_BLOCKJAC=1`` (K8)."""
    spec = BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_optin: no CUDA device available")
    if order == 0:
        tol, mesh = FULL_TOL, (6, 4)
        with env(NEUTFEM_EQFOLD="2"):
            run = BenchmarkRun(spec, *mesh, device=device, dtype=dtype)
        variants = {"default": (run, {}), "eqfold1": (run, {"NEUTFEM_EQFOLD": "1"}),
                    "eqfold2": (run, {"NEUTFEM_EQFOLD": "2"}), "cgcg": (run, {"NEUTFEM_CGCG": "1"})}
    else:
        tol, mesh = HO_TOL, (4, 2)
        fp8 = BenchmarkRun(spec, *mesh, device=device, dtype=dtype, rt_order=order)
        with env(NEUTFEM_BLKFP8="0"):
            bf16 = BenchmarkRun(spec, *mesh, device=device, dtype=dtype, rt_order=order)
        variants = {"default_fp8": (fp8, {}), "bf16_bmm": (bf16, {}),
                    "bf16_blockjac": (bf16, {"NEUTFEM_BLOCKJAC": "1"})}

    def solve(name):
        run, switches = variants[name]
        s = run.solver
        s.set_tol(*tol)
        s.reset_flux()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with env(**switches):
            t0 = time.time()
            keff = s.SolveKeff()  # ends in a device -> host read of k
            wall = time.time() - t0
        return {"keff": round(keff, 7), "outers": s._last_outers, "inners": s._last_inners,
                "ms_per_outer": 1e3 * wall / max(s._last_outers, 1)}

    names = list(variants)
    out = {name: solve(name) for name in names}  # the untimed first solves
    for name in names:
        out[name]["rounds_ms_per_outer"] = []
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            res = solve(name)
            out[name]["rounds_ms_per_outer"].append(round(res["ms_per_outer"], 3))
            out[name].update(keff=res["keff"], outers=res["outers"], inners=res["inners"])
    for res in out.values():
        res.pop("ms_per_outer")
        res["median_ms_per_outer"] = float(np.median(res["rounds_ms_per_outer"]))
    result = {"metric": "optin_ab_ms_per_outer",
              "mesh": f"{mesh[0]}x{mesh[0]}x{mesh[1]} RT{order}-P{order}",
              "device": _device_name(device), "dtype": str(dtype), "rounds": rounds,
              "variants": out}
    print(json.dumps(result))
    return result


def main_full(json_path: Optional[str] = None, device="cuda") -> list:
    """``bench.py --full``'s measured rows, float32, in its order: IAEA-3D
    6x6x4 (``main``), RT1-P1 and RT2-P2 4x4x2 (``main_ho``), 8x8x6
    (``main_2p6m``), 8x8x8 (``main_scale``), KOEBERG 32x32 and ZION 48x48
    (``main_2d``) and the 6x6x4 free-running adjoint (``main_adjoint``); each
    prints its JSON line.  Returns the rows and, given ``json_path``, writes
    them there as one JSON list; no file otherwise.  The JAX function's rows
    ``twogrid_precond_adjudication`` and ``sharded_1device_mesh_real_tpu``
    are constants typed in from TPU runs, not measurements: not here."""
    rows = [main(6, 4, device=device), main_ho(1, device=device), main_ho(2, device=device),
            main_2p6m(device=device), main_scale(device=device),
            main_2d("koeberg2d", 32, device=device), main_2d("zion2d", 48, device=device),
            main_adjoint(device=device)]
    if json_path:
        _write_json(json_path, rows)
    return rows


def cli(argv=None):
    """The command line (``python -m neutfem_tpu_torch.bench --help``); returns
    what the row function it runs returns."""
    ap = argparse.ArgumentParser(description="k-eff benchmarks on the GPU (float32)")
    ap.add_argument("mesh_n", nargs="?", type=int, default=None,
                    help="cells per assembly and axis (default 6, 4 with --order, "
                         "32 with --core koeberg2d, 48 with --core zion2d)")
    ap.add_argument("mesh_nz", nargs="?", type=int, default=None,
                    help="axial subdivisions per plane (default 4, or 2 with --order)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--order", type=int, default=0,
                      help="RT_k-P_k order; 0 runs main(), 1 and 2 the higher-order rows")
    mode.add_argument("--core", choices=sorted(CORES_2D), default=None,
                      help="a fine 2D core row (main_2d)")
    mode.add_argument("--scale", action="store_true",
                      help="the IAEA-3D 8x8x8 (3.5M-cell) row (main_scale)")
    mode.add_argument("--adjoint", action="store_true",
                      help="the IAEA-3D free-running adjoint row (main_adjoint)")
    mode.add_argument("--sweep", choices=("gs", "jacobi"), default=None,
                      help="one IAEA-3D solve with this group sweep (main_sweep)")
    mode.add_argument("--accel", action="store_true",
                      help="the accelerator matrix (main_accel)")
    mode.add_argument("--variants", action="store_true",
                      help="the solver features outside the main path (main_variants)")
    mode.add_argument("--full", action="store_true",
                      help="bench.py --full's measured rows (main_full)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="with --full or --accel: also write the rows to PATH as one JSON list")
    ap.add_argument("--optin", action="store_true",
                    help="the opt-in switches against the default path at --order (main_optin)")
    a = ap.parse_args(argv)
    if a.json is not None and not (a.full or a.accel):
        ap.error("--json goes with --full or --accel")
    if a.optin:
        return main_optin(a.order)
    if a.full:
        return main_full(a.json)
    if a.accel:
        return main_accel(json_path=a.json)
    if a.variants:
        return main_variants()
    if a.scale:
        return main_scale()
    if a.adjoint:
        return main_adjoint(a.mesh_n or 6, a.mesh_nz or 4)
    if a.sweep is not None:
        return main_sweep(a.sweep, a.mesh_n or 6, a.mesh_nz or 4)
    if a.core is not None:
        return main_2d(a.core, a.mesh_n or {"koeberg2d": 32, "zion2d": 48}[a.core])
    if a.order == 0:
        return main(a.mesh_n or 6, a.mesh_nz or 4)
    return main_ho(a.order, a.mesh_n or 4, a.mesh_nz or 2)


if __name__ == "__main__":
    cli()
