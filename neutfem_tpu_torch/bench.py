"""IAEA-3D k-eff benchmark on the PyTorch port (one JSON line, as ``bench.py``).

Port of ``benchmarks/runner.BenchmarkRun`` (full-core domain "entier") and of
``bench.main``: IAEA-3D at --mesh NxN per assembly and M axial subdivisions per
plane, RT0-P0, two groups; one warm-up solve, then three timed solves from a
cold flux (``reset_flux`` before each) and the median reported as seconds per
outer iteration.  The benchmark data come from ``benchmarks/data.py``, loaded
by file path (it imports only numpy), so nothing of the JAX package is loaded.

Run on a GPU with ``python -m neutfem_tpu_torch.bench [N [M]]``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .compat import BCType, LinearSolverType, NeutFEM, VerbosityLevel
from .mesh import boundary_attribute

__all__ = ["BenchmarkRun", "load_benchmark_data", "main"]

#: Measured CPU cost of the reference algorithm (the scipy transcription in
#: tests/ref_replica.py), the same constant as bench.py's vs_baseline.
CPU_SECONDS_PER_CELL_PER_OUTER = 8.84e-6

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
    """Domain slicing; the port runs the full core only."""
    if domain != "entier":
        raise NotImplementedError(f"domain {domain!r}: only 'entier' is ported")
    return grid


class BenchmarkRun:
    """Holds the solver + results of one benchmark execution."""

    def __init__(self, spec, mesh_n: int = 2, mesh_nz: int = 1, domain: str = "entier",
                 verbose: bool = False, *, device, dtype=None):
        self.spec = spec
        self.mesh_n = mesh_n
        self.mesh_nz = mesh_nz
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

        s = NeutFEM(0, spec.ng, x_breaks, y_breaks, z_breaks, device=device, dtype=dtype)
        s.set_verbosity(VerbosityLevel.NORMAL if self.verbose else VerbosityLevel.SILENT)
        s.set_linear_solver(LinearSolverType.BICGSTAB)
        for axis in range(spec.dim):  # full core: vacuum (Marshak) on every face
            for upper in (False, True):
                s.set_bc(boundary_attribute(spec.dim, axis, upper), BCType.DIRICHLET, 0.0)
        self._fill_xs(s)
        s.BuildMatrices()
        self.solver = s

    def _material_at(self, grid, k, i, j):
        spec = self.spec
        ch = grid[k, i, j]
        if ch != ".":
            return spec.materials[ch]
        if spec.baffle is not None:
            # ZION: empty cells within one baffle-thickness of fuel are steel baffle,
            # others are water (zion2d.py:265-303 nearest-assembly search).
            mat_b, thick, fuel_chars = spec.baffle
            cell = spec.pitch / self.mesh_n
            r = max(1, int(np.ceil(thick / cell)))
            nz, ny, nx = grid.shape
            for di in range(-r, r + 1):
                for dj in range(-r, r + 1):
                    ii, jj = i + di, j + dj
                    if 0 <= ii < ny and 0 <= jj < nx and grid[k, ii, jj] in fuel_chars:
                        return mat_b
        return spec.background

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
            baffle = np.zeros(grid.shape, dtype=bool)
            for k, i, j in zip(*np.nonzero(sel)):  # baffle search per empty cell
                baffle[k, i, j] = self._material_at(grid, k, i, j) is spec.baffle[0]
            put(sel & baffle, spec.baffle[0])
            put(sel & ~baffle, spec.background)

        def sq(a):
            return a[..., 0, :, :] if spec.dim == 2 else a

        s.get_D()[:] = sq(D)
        s.get_SigR()[:] = sq(SigR)
        s.get_NSF()[:] = sq(NSF)
        s.get_Chi()[:] = sq(Chi)
        s.get_SigS()[:] = sq(SigS)
        s.get_KSF()[:] = sq(NSF)  # power proxy

    def solve(self, tol=(1e-5, 1e-4, 1e-4, 200, 1000)):
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
    tol = (1e-5, 1e-4, 1e-4, 200, 1000)

    # solve 1 is a warm-up; then three timed solves from a cold flux, median
    run.solve(tol=tol)
    walls = []
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
            "mesh": f"{mesh_n}x{mesh_n}x{mesh_nz}",
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            "dtype": str(run.solver._dtype),
        },
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    main(n, nz)
