"""The port's literature-core entry points against the JAX package on the CPU.

* ``neutfem_tpu_torch.data`` equals ``benchmarks/data.py`` field by field
  (each core, and the IAEA-2D assembly power map);
* ``runner.run_benchmark(..., device="cpu")`` against
  ``benchmarks.runner.run_benchmark`` at float64 on the five cores at their
  smallest meshes: |dk| <= 1e-9, the same outer count, inner totals within 2;
  the adjoint k (BIBLIS and IAEA-2D 2x2), the assembly power factors ``Fass``
  of every 2D core and IAEA-2D's ``power_deviation`` to rel 1e-9; CMFD and
  the coarse-grid initialization at ``tests/test_torch_variants.py``'s
  tolerances for those paths (a whole CMFD solve is not reproducible to
  rounding: k within 2e-6 at tol_keff 1e-6, outers within 10%);
* ``runner.main`` prints the JAX runner's lines;
* ``validate.CASES`` and ``run_ladder``'s defaults equal the JAX tools', and
  ``validate`` / ``run_ladder`` run on the CPU (the ladder against
  ``benchmarks.parity.run_ladder``);
* the literature pins of ``tests/test_benchmarks.py`` on the port.
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmarks.data as j_data
from benchmarks import parity as j_parity
from benchmarks import runner as j_runner
from neutfem_tpu.coarse import default_coarse_factors as j_default_coarse_factors
from neutfem_tpu_torch import data as t_data
from neutfem_tpu_torch import runner as t_runner
from neutfem_tpu_torch import validate as t_validate
from neutfem_tpu_torch.bench import BenchmarkRun
from neutfem_tpu_torch.coarse import default_coarse_factors

torch.set_num_threads(1)

F64 = torch.float64
#: tests/test_benchmarks.py's and tests/test_torch_variants.py's tolerances
#: (k, flux, L2, outers, inners)
PIN_TOL = (1e-6, 1e-5, 1e-5, 300, 1000)
SPEC_FIELDS = ("name", "ng", "kref", "pitch", "layout", "layout3d", "pitch_z", "materials",
               "background", "n_fuel_assemblies", "baffle", "dim")


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = np.nanmax(np.abs(want))
    return float(np.nanmax(np.abs(got - want)) / scale)


@pytest.mark.parametrize("name", sorted(j_data.BENCHMARKS))
def test_core_data_matches_jax(name):
    assert sorted(t_data.BENCHMARKS) == sorted(j_data.BENCHMARKS)
    t, j = t_data.BENCHMARKS[name], j_data.BENCHMARKS[name]
    for field in SPEC_FIELDS:
        assert getattr(t, field) == getattr(j, field), field
    for mat in (*j.materials.values(), j.background):
        assert t_data.sigr_of(mat, j.ng) == j_data.sigr_of(mat, j.ng)


def test_power_map_matches_jax():
    assert t_data.IAEA2D_POWER_MAP.shape == j_data.IAEA2D_POWER_MAP.shape == (19, 19)
    assert np.array_equal(t_data.IAEA2D_POWER_MAP, j_data.IAEA2D_POWER_MAP, equal_nan=True)


#: run id -> (core, mesh_n, mesh_nz, run_benchmark keywords)
RUNS = {
    "iaea2d": ("iaea2d", 2, 1, {"adjoint": True}),
    "biblis2d": ("biblis2d", 2, 1, {"adjoint": True}),
    "koeberg2d": ("koeberg2d", 2, 1, {}),
    "zion2d": ("zion2d", 2, 1, {}),
    "iaea3d": ("iaea3d", 1, 1, {}),
    # at test_torch_variants.py's tolerances, where its CMFD case holds 2e-6
    "iaea2d_cmfd": ("iaea2d", 2, 1, {"use_cmfd": True, "tol": PIN_TOL}),
    "biblis2d_coarse": ("biblis2d", 2, 1, {"use_coarse_init": True}),
}
_PAIRS = {}


def _pair(rid):
    """(JAX run, port run) of ``RUNS[rid]``, each solved once, cached."""
    if rid not in _PAIRS:
        core, n, nz, kw = RUNS[rid]
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("use_coarse_init"):  # the CLIs' --coarse: the default factors of the mesh
            jrun = j_runner.BenchmarkRun(j_data.BENCHMARKS[core], mesh_n=n, mesh_nz=nz)
            jkw["coarse_factors"] = j_default_coarse_factors(jrun.solver._mesh)
            trun = BenchmarkRun(t_data.BENCHMARKS[core], n, nz, device="cpu", dtype=F64)
            tkw["coarse_factors"] = default_coarse_factors(trun.solver._mesh)
            assert tkw["coarse_factors"] == jkw["coarse_factors"]
        jrun = j_runner.run_benchmark(core, mesh_n=n, mesh_nz=nz, **jkw)
        trun = t_runner.run_benchmark(core, mesh_n=n, mesh_nz=nz, device="cpu", dtype=F64, **tkw)
        _PAIRS[rid] = (jrun, trun)
    return _PAIRS[rid]


@pytest.mark.parametrize("rid", ["iaea2d", "biblis2d", "koeberg2d", "zion2d", "iaea3d",
                                 "biblis2d_coarse"])
def test_run_benchmark_matches_jax(rid):
    j, t = _pair(rid)
    assert t.solver._dtype == F64
    assert abs(t.keff - j.keff) <= 1e-9
    assert abs(t.pcm - j.pcm) <= 1e-4  # 1e5 / k^2 times dk
    assert t.solver._last_outers == j.solver._last_outers == t.outer_iterations
    assert abs(t.solver._last_inners - j.solver._last_inners) <= 2


@pytest.mark.parametrize("rid", ["iaea2d", "biblis2d"])
def test_adjoint_matches_jax(rid):
    j, t = _pair(rid)
    assert t.keff_adj is not None and abs(t.keff_adj - j.keff_adj) <= 1e-9
    assert _rel(t.solver.get_flux_adj(), j.solver.get_flux_adj()) <= 1e-7


@pytest.mark.parametrize("rid", ["iaea2d", "biblis2d", "koeberg2d", "zion2d"])
def test_power_factors_match_jax(rid):
    j, t = _pair(rid)
    n_assemblies = len(t_data.BENCHMARKS[RUNS[rid][0]].layout)
    assert t.Fass.shape == j.Fass.shape == (n_assemblies, n_assemblies)
    assert _rel(t.Fass, j.Fass) <= 1e-9


def test_power_deviation_matches_jax():
    j, t = _pair("iaea2d")
    got = t.power_deviation(t_data.IAEA2D_POWER_MAP)
    want = j.power_deviation(j_data.IAEA2D_POWER_MAP)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert _rel(got, want) <= 1e-9


def test_no_power_factors_off_the_full_2d_core():
    _, t = _pair("iaea3d")
    assert t.Fass is None
    run = t_runner.run_benchmark("iaea2d", mesh_n=1, domain="quart_so", device="cpu", dtype=F64)
    assert run.Fass is None and run.keff > 0


def test_cmfd_matches_jax():
    j, t = _pair("iaea2d_cmfd")
    assert abs(t.keff - j.keff) <= 2e-6
    assert abs(t.solver._last_outers - j.solver._last_outers) <= 0.1 * j.solver._last_outers


def test_runner_main_prints_jax_lines(capsys):
    argv = ["--mesh", "2x2", "--adjoint"]
    j_runner.main("biblis2d", argv)
    jout = capsys.readouterr().out
    run = t_runner.main("biblis2d", [*argv, "--device", "cpu"])
    tout = capsys.readouterr().out
    assert run.solver._device.type == "cpu"

    def lines(out):  # the result lines, the wall time dropped
        return [re.sub(r"\s+wall = \S+", "", ln) for ln in out.splitlines()
                if ln.startswith(("biblis2d:", "  adjoint", "  assembly"))]

    assert len(lines(tout)) == 3
    assert lines(tout) == lines(jout)


def test_runner_cli_rejects_an_unknown_core():
    proc = subprocess.run([sys.executable, "-m", "neutfem_tpu_torch.runner", "nocore"],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0 and "usage" in proc.stderr


def test_validate_cases_match_jax(monkeypatch):
    # benchmarks/validate_tpu sets NEUTFEM_X64=0 by setdefault on import: keep
    # this process's value (and restore the variable after the test)
    monkeypatch.setenv("NEUTFEM_X64", os.environ.get("NEUTFEM_X64", "1"))
    from benchmarks import validate_tpu

    assert t_validate.CASES == validate_tpu.CASES


def test_ladder_defaults_match_jax():
    assert t_validate.DEFAULT_CORES == j_parity.DEFAULT_CORES
    assert t_validate.DEFAULT_MESHES == j_parity.DEFAULT_MESHES
    jtol = inspect.signature(j_parity.run_ladder).parameters["tol"].default
    ttol = inspect.signature(t_validate.run_ladder).parameters["tol"].default
    assert ttol == t_validate.LADDER_TOL == jtol


@pytest.mark.parametrize("bound,passes", [(100.0, True), (1.0, False)])
def test_validate_rows_on_the_cpu(bound, passes, capsys):
    cases = [("iaea2d", dict(mesh_n=1), bound)]
    if not passes:  # |pcm| is ~90 at 1x1 (tests/test_benchmarks.py)
        with pytest.raises(SystemExit, match="SOME FAILED"):
            t_validate.validate(cases, device="cpu", dtype=F64)
        return
    (row,) = t_validate.validate(cases, device="cpu", dtype=F64)
    assert "ALL OK" in capsys.readouterr().out
    j = j_runner.BenchmarkRun(j_data.BENCHMARKS["iaea2d"], mesh_n=1)
    j.solve()
    assert abs(row["keff"] - j.keff) <= 1e-9 and row["ok"]
    assert (row["name"], row["mesh"], row["n_cells"], row["preconditioner"]) == (
        "iaea2d", "1x1", 361, "jacobi")
    assert row["outer_iterations"] == j.solver._last_outers
    assert row["cg"]["solves"] > 0 and row["launches"] == {}  # no kernel on the CPU
    assert row["power_max_dev_pct"] == pytest.approx(
        float(np.nanmax(np.abs(j.power_deviation(j_data.IAEA2D_POWER_MAP)))), rel=1e-9)


def test_run_ladder_matches_jax_parity(capsys):
    (t,) = t_validate.run_ladder(cores=("biblis2d",), meshes=(1,), device="cpu", dtype=F64)
    (j,) = j_parity.run_ladder(cores=("biblis2d",), meshes=(1,))
    capsys.readouterr()
    for key in ("core", "mesh", "n_cells", "ng", "kref", "outer_iterations"):
        assert t[key] == j[key], key
    assert abs(t["keff"] - j["keff"]) <= 1e-7  # the JAX row's k is rounded to 7 digits
    assert t["outer_iterations"] < t_validate.LADDER_TOL[3]


@pytest.mark.parametrize("core,n,k_pin,k_tol,pcm_max", [
    ("iaea2d", 4, 1.029375, 3e-5, 25.0),
    ("biblis2d", 4, 1.025198, 3e-5, 15.0),
    ("zion2d", 2, 1.277192, 5e-5, 160.0),
])
def test_literature_pins(core, n, k_pin, k_tol, pcm_max):
    """tests/test_benchmarks.py's pins of the JAX package, on the port."""
    run = t_runner.run_benchmark(core, mesh_n=n, tol=PIN_TOL, device="cpu", dtype=F64)
    assert run.keff == pytest.approx(k_pin, abs=k_tol)
    assert abs(run.pcm) < pcm_max


def test_benchmark_run_solve_keeps_its_old_call():
    """``solve(tol)`` alone, as the bench rows call it: the direct solve only."""
    run = BenchmarkRun(t_data.BENCHMARKS["iaea2d"], 1, device="cpu", dtype=F64)
    k = run.solve(PIN_TOL)
    assert k == run.keff and run.keff_adj is None and run.Fass is not None
    assert run.solve_seconds > 0 and run.outer_iterations == run.solver._last_outers
