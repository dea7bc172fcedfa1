"""The port's examples (``neutfem_tpu_torch/examples/``) against the JAX
examples' calls, made here through the JAX package, on the CPU at float64.

* ``quickstart`` (a 1D two-group slab): k to 1e-9, the flux shape;
* ``subcritical_source`` (a 2D 20 x 20 source-driven system): k and M to
  1e-9 relative, the peak to source-cell flux ratio;
* ``convergence_study`` (IAEA-2D, RT0 1x1 / 2x2 / 4x4, RT1 1x1 / 2x2, RT2
  1x1): each row's k to 1e-9 and the same outer count.

Each at the example's own mesh.  Importing an example runs nothing (the
package import test walks them).
"""

import numpy as np
import pytest
import torch

import neutfem._neutfem_eigen as nf
from benchmarks.data import BENCHMARKS
from benchmarks.runner import BenchmarkRun as JRun
from neutfem._neutfem_eigen import BCType, BoundaryID
from neutfem_tpu_torch.examples import convergence_study, quickstart, subcritical_source

F64 = torch.float64


def test_quickstart_matches_jax(capsys):
    solver = nf.NeutFEM(order=0, ng=2, x_breaks=np.linspace(0, 100, 11),
                        y_breaks=np.array([0.0]), z_breaks=np.array([0.0]))
    solver.get_D()[:] = 1.5
    solver.get_SigR()[:] = 0.02
    solver.get_SigS()[1, 0, :] = 0.015
    solver.get_NSF()[0, :] = 0.005
    solver.get_NSF()[1, :] = 0.02
    solver.get_Chi()[0, :] = 1.0
    solver.set_bc(BoundaryID.LEFT_1D, BCType.MIRROR)
    solver.set_bc(BoundaryID.RIGHT_1D, BCType.DIRICHLET, 0.0)
    solver.BuildMatrices()
    k = solver.SolveKeff()
    capsys.readouterr()
    got = quickstart.main(device="cpu", dtype=F64)
    assert abs(got["keff"] - k) <= 1e-9
    assert got["flux_shape"] == solver.get_flux().shape == (2, 10)
    out = capsys.readouterr().out.splitlines()  # the facade's own lines, then the example's
    assert out[-2:] == [f"k-effective = {got['keff']:.6f}", f"flux shape  = {(2, 10)}"]


def test_subcritical_source_matches_jax():
    n = subcritical_source.N
    s = nf.NeutFEM(0, 2, np.linspace(0, 100, n + 1), np.linspace(0, 100, n + 1),
                   np.array([0.0]))
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, BCType.DIRICHLET)
    s.get_D()[0], s.get_D()[1] = 1.4, 0.4
    s.get_SigR()[0], s.get_SigR()[1] = 0.028, 0.10
    s.get_NSF()[0], s.get_NSF()[1] = 0.003, 0.07
    s.get_Chi()[0] = 1.0
    s.get_SigS()[1, 0] = 0.018
    s.get_SRC()[0, n // 2, n // 2] = 1.0
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-7, 1e-9, 300)
    k = s.SolveKeff()
    s.reset_flux()
    m = s.SolveSubcritical()
    flux = np.asarray(s.get_flux()[0])
    got = subcritical_source.main(device="cpu", dtype=F64)
    assert n == 20 and got["keff"] < 1.0 < got["M"]
    assert abs(got["keff"] - k) <= 1e-9 * k
    assert abs(got["M"] - m) <= 1e-9 * m
    assert got["peak_ratio"] == pytest.approx(flux.max() / flux[n // 2, n // 2], rel=1e-9)


def test_convergence_study_matches_jax():
    got = convergence_study.main(device="cpu", dtype=F64)
    assert [r["label"] for r in got] == [c[0] for c in convergence_study.CONFIGS]
    assert convergence_study.TOL == (1e-6, 1e-5, 1e-5, 300, 2000)
    for row, (label, n, rt) in zip(got, convergence_study.CONFIGS):
        run = JRun(BENCHMARKS["iaea2d"], mesh_n=n, rt_order=rt)
        run.solve(tol=convergence_study.TOL)
        assert abs(row["keff"] - run.keff) <= 1e-9, label
        assert row["outers"] == run.solver._last_outers, label
        assert row["pcm"] == pytest.approx(run.pcm, abs=1e-6), label
