"""The port's NeutFEM facade against the JAX facade: the switches and the
health checks they share (float64, CPU).

* ``NEUTFEM_INNER_ETA``: both facades read it where they build the solve
  options; ``=0`` (the reference's fixed inner tolerance) on IAEA-3D 1x1
  RT0-P0 gives the same k (|dk| <= 1e-9) and the same counts (49 outers,
  371 inners) in both, and neither warns there;
* the implausible-eigenvalue warning: a finite k outside [0.5, 2.0] makes
  ``SolveKeff`` and the free-running ``SolveAdjoint`` of both facades warn
  with ``RuntimeWarning``.
"""

import warnings

import numpy as np
import pytest
import torch

import neutfem
from neutfem_tpu_torch import compat

F64 = torch.float64
TOL = (1e-6, 1e-5, 1e-5, 300, 1000)  # the benchmark tests' tolerances


def _health_warnings(record):
    return [str(w.message) for w in record
            if issubclass(w.category, RuntimeWarning)
            and ("implausible" in str(w.message) or "non-finite" in str(w.message))]


def test_inner_eta_zero_matches_jax_facade(monkeypatch):
    from benchmarks.data import BENCHMARKS
    from benchmarks.runner import BenchmarkRun as JRun
    from neutfem_tpu_torch.bench import BenchmarkRun

    monkeypatch.setenv("NEUTFEM_INNER_ETA", "0")
    spec = BENCHMARKS["iaea3d"]
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        jrun = JRun(spec, mesh_n=1, mesh_nz=1)
        jrun.solve(tol=TOL)
        trun = BenchmarkRun(spec, mesh_n=1, mesh_nz=1, device="cpu", dtype=F64)
        assert trun.solver._opts().inner_eta == 0.0
        trun.solve(tol=TOL)
    assert _health_warnings(record) == []
    assert abs(trun.keff - jrun.keff) <= 1e-9
    assert trun.solver._last_outers == jrun.solver._last_outers == 49
    assert trun.solver._last_inners == jrun.solver._last_inners == 371


def _supercritical(make):
    """A one-group 4x4 2D square with mirror faces all round and
    nu*Sigma_f / Sigma_r = 3: k = k_inf = 3."""
    s = make(0, 1, np.linspace(0.0, 8.0, 5), np.linspace(0.0, 8.0, 5), np.array([0.0]))
    s.set_verbosity(0)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, 2)  # MIRROR
    s.get_D()[...] = 1.2
    s.get_SigR()[...] = 0.05
    s.get_NSF()[...] = 0.15
    s.get_Chi()[...] = 1.0
    s.BuildMatrices()
    s.set_tol(*TOL)
    return s


@pytest.mark.parametrize("facade", ["jax", "torch"])
def test_implausible_keff_warns(facade):
    make = (neutfem.NeutFEM if facade == "jax"
            else lambda *a: compat.NeutFEM(*a, device="cpu", dtype=F64))
    s = _supercritical(make)
    with pytest.warns(RuntimeWarning, match="implausible eigenvalue"):
        k = s.SolveKeff()
    assert k == pytest.approx(3.0, rel=1e-5)
    with pytest.warns(RuntimeWarning, match="implausible eigenvalue"):
        k_adj = s.SolveAdjoint(normalize_to_direct=False, use_direct_keff=False)
    assert k_adj == pytest.approx(3.0, rel=1e-5)
