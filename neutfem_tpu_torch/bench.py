"""k-eff benchmarks on the PyTorch port (one JSON line each, as ``bench.py``).

Port of ``benchmarks/runner.BenchmarkRun`` (the full core and the quarter and
half domains with their mirror cut planes), of ``bench.main``, of rows of
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
  then one timed solve from a cold flux; one JSON row each.

``main_ho``, ``main_2d`` and ``main_scale`` run as ``bench.py --full`` does:
one solve, ``reset_flux``, then one timed solve from a cold flux.  The
benchmark data come from ``benchmarks/data.py``, loaded by file path (it
imports only numpy), so nothing of the JAX package is loaded.

Run on a GPU with ``python -m neutfem_tpu_torch.bench [N [M]] [--order K |
--core {koeberg2d,zion2d} | --scale | --adjoint | --sweep {gs,jacobi} |
--accel]``, or ``python -m neutfem_tpu_torch.bench --optin [--order K]``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from . import krylov
from .compat import BCType, LinearSolverType, NeutFEM, VerbosityLevel
from .mesh import boundary_attribute
from .ops import launch_counters
from .power import power_iteration

__all__ = ["BenchmarkRun", "load_benchmark_data", "main", "main_ho", "main_2d", "main_scale",
           "main_adjoint", "main_sweep", "main_optin", "main_accel", "env"]

#: Measured CPU cost of the reference algorithm (the scipy transcription in
#: tests/ref_replica.py), the same constant as bench.py's vs_baseline.
CPU_SECONDS_PER_CELL_PER_OUTER = 8.84e-6

#: ``bench.py``'s RT0 tolerances (k, flux, L2, outers, inners), its
#: ``--full`` rows' too.
FULL_TOL = (1e-5, 1e-4, 1e-4, 200, 1000)

_DATA_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks", "data.py")
_data_module = None


def load_benchmark_data():
    """The ``benchmarks/data.py`` module, loaded by path (not as ``benchmarks.data``,
    whose package imports the JAX runner)."""
    global _data_module
    if _data_module is None:
        spec = importlib.util.spec_from_file_location("neutfem_tpu_torch._benchmark_data",
                                                      _DATA_PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _data_module = mod
    return _data_module


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
                 p_order: Optional[int] = None):
        if domain not in CUTS:
            raise ValueError(f"unsupported domain {domain!r}")
        self.spec = spec
        self.mesh_n = mesh_n
        self.mesh_nz = mesh_nz
        self.rt_order = int(rt_order)
        self.p_order = int(p_order) if p_order is not None else self.rt_order
        self.domain = domain
        self.verbose = verbose
        self.keff: Optional[float] = None
        self.solve_seconds: Optional[float] = None
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
                s.set_bc(boundary_attribute(spec.dim, axis, upper), kind, 0.0)
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
        sigr_of = load_benchmark_data().sigr_of

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

    def solve(self, tol=FULL_TOL):
        s = self.solver
        s.set_tol(*tol)
        t0 = time.time()
        self.keff = s.SolveKeff()
        self.solve_seconds = time.time() - t0
        return self.keff

    @property
    def pcm(self) -> float:
        """Reactivity deviation vs k_ref: 1e5 (1/k_ref - 1/k) (iaea2d.py:389)."""
        return 1e5 * (1.0 / self.spec.kref - 1.0 / self.keff)


def _cg_detail() -> dict:
    """The CG counts of the timed solve(s) (``krylov.STATS``, reset just
    before them) and host reads per CG iteration."""
    st = dict(krylov.STATS)
    st["host_reads_per_iteration"] = round(st["host_reads"] / max(st["iterations"], 1), 4)
    return st


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def main(mesh_n: int = 6, mesh_nz: int = 4, device="cuda", dtype=torch.float32) -> dict:
    """IAEA-3D solve timing; prints one JSON line and returns it as a dict.

    The default device is the GPU: a measurement that finds no card fails.
    The default dtype is float32, the benchmark path of the JAX package too."""
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main: no CUDA device available")
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False,
                       device=device, dtype=dtype)
    n_cells = run.solver.GetNumElements()

    # solve 1 is a warm-up; then three timed solves from a cold flux, median
    run.solve(tol=FULL_TOL)
    walls = []
    krylov.reset_stats()
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
            dtype=torch.float32) -> dict:
    """IAEA-3D RT_k-P_k solve timing (k = ``order``); prints one JSON line with
    the JAX package's metric name and detail keys and returns it as a dict.

    As ``bench.py --full``: one solve, ``reset_flux``, then one timed solve from
    a cold flux.  A measurement that finds no card fails."""
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_ho: no CUDA device available")
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False,
                       device=device, dtype=dtype, rt_order=order)
    run.solve(tol=HO_TOL)
    run.solver.reset_flux()
    krylov.reset_stats()
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


def _timed_run(spec, what: str, device, dtype, **kwargs):
    """Build, solve once, ``reset_flux``, then one timed solve from a cold flux
    (``bench.py --full``).  Returns (run, keff, wall seconds)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bench.{what}: no CUDA device available")
    run = BenchmarkRun(spec, verbose=False, device=device, dtype=dtype, **kwargs)
    run.solve(tol=FULL_TOL)
    run.solver.reset_flux()
    krylov.reset_stats()
    t0 = time.time()
    keff = run.solver.SolveKeff()  # ends in a device -> host read of k
    return run, keff, time.time() - t0


def main_2d(core: str, mesh_n: int, device="cuda", dtype=torch.float32) -> dict:
    """A fine 2D core's solve timing (``core`` in ``CORES_2D``); prints one JSON
    line with the JAX row's metric name and detail keys, plus the device, the
    dtype and the preconditioner the group solves ran, and returns it."""
    spec = load_benchmark_data().BENCHMARKS[core]
    run, keff, wall = _timed_run(spec, "main_2d", device, dtype, mesh_n=mesh_n)
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


def main_scale(device="cuda", dtype=torch.float32) -> dict:
    """IAEA-3D 8x8x8 (3.5M cells) solve timing, the JAX package's
    ``iaea3d_3p5M`` row; prints one JSON line and returns it."""
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
    run, keff, wall = _timed_run(spec, "main_scale", device, dtype, mesh_n=8, mesh_nz=8)
    s = run.solver
    outers = s._last_outers
    out = {
        "metric": "iaea3d_3p5M_seconds_per_outer_iteration",
        "value": round(wall / max(outers, 1), 6), "unit": "s/outer",
        "detail": {
            "keff": round(keff, 7),
            "pcm": round(1e5 * (1.0 / spec.kref - 1.0 / keff), 2),
            "n_cells": s.GetNumElements(),
            "outer_iterations": outers,
            "inner_iterations": s._last_inners,
            "solve_wall_s": round(wall, 3), "cg": _cg_detail(), "mesh": "8x8x8",
            "device": _device_name(s._device), "dtype": str(s._dtype),
            "preconditioner": s.preconditioner(),
        },
    }
    print(json.dumps(out))
    return out


def main_adjoint(mesh_n: int = 6, mesh_nz: int = 4, device="cuda", dtype=torch.float32) -> dict:
    """``bench.py --full``'s IAEA-3D free-running adjoint row: a direct solve,
    one adjoint solve, then one timed adjoint solve from a cold adjoint flux
    (free-running, so it also checks k-adjoint against k-direct); prints one
    JSON line with the JAX row's metric name and detail keys, plus the device
    and the dtype, and returns it."""
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_adjoint: no CUDA device available")
    run = BenchmarkRun(spec, mesh_n=mesh_n, mesh_nz=mesh_nz, verbose=False, device=device,
                       dtype=dtype)
    k_direct = run.solve(tol=FULL_TOL)
    s = run.solver
    s.SolveAdjoint(use_direct_keff=False)
    s._phi_adj = None  # cold adjoint flux
    krylov.reset_stats()
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
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
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
    krylov.reset_stats()
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
               dtype=torch.float32) -> list:
    """The accelerator matrix (``benchmarks/accel_compare.run_matrix``): for
    each configuration and accelerator one solve, then one timed solve from a
    cold flux; prints one JSON row each (k, outers, inners, wall, ms/outer,
    the CG counts, the kernel launches of the timed solve and the card's name
    and power limit) and returns the rows.  Asserts the accelerators reach
    the same fixed point: their k spread below 3 tol_keff."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench.main_accel: no CUDA device available")
    card = card_line(device)
    data = load_benchmark_data()
    rows = []
    for name, kwargs, tol in configs:
        run = BenchmarkRun(data.BENCHMARKS[name], verbose=False, device=device, dtype=dtype,
                           **kwargs)
        s = run.solver
        s.set_tol(*tol)
        keffs = {}
        for accel in accels:
            s.set_acceleration(accel)
            s.reset_flux()
            s.SolveKeff()
            s.reset_flux()
            krylov.reset_stats()
            before = {k: v for c in launch_counters() for k, v in c.items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.time()
            keff = s.SolveKeff()  # ends in a device -> host read of k
            wall = time.time() - t0
            launches = {k: v - before[k] for c in launch_counters() for k, v in c.items()
                        if v != before[k]}
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
    return rows


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
    spec = load_benchmark_data().BENCHMARKS["iaea3d"]
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


if __name__ == "__main__":
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
    ap.add_argument("--optin", action="store_true",
                    help="the opt-in switches against the default path at --order (main_optin)")
    a = ap.parse_args()
    if a.optin:
        main_optin(a.order)
    elif a.accel:
        main_accel()
    elif a.scale:
        main_scale()
    elif a.adjoint:
        main_adjoint(a.mesh_n or 6, a.mesh_nz or 4)
    elif a.sweep is not None:
        main_sweep(a.sweep, a.mesh_n or 6, a.mesh_nz or 4)
    elif a.core is not None:
        main_2d(a.core, a.mesh_n or {"koeberg2d": 32, "zion2d": 48}[a.core])
    elif a.order == 0:
        main(a.mesh_n or 6, a.mesh_nz or 4)
    else:
        main_ho(a.order, a.mesh_n or 4, a.mesh_nz or 2)
