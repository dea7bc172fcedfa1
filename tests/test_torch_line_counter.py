"""The line preconditioner's counter and the benchmark cell that reads it, on
the CPU.

``precond.line_applies`` (``power.LINE_APPLIES``): the line solves a solve's
CGs launched, counted by the line apply itself with ``tracing.count``, in
the solve records; held against the solves counted by wrapping the line
solve, on IAEA-3D 1x1x1 (6,859 cells) under "line", "line2" and Jacobi, and,
for a counter counted inside a preconditioner, against its calls in each
Krylov recurrence and block size, wrapped or not.  Then the configuration ``iaea3d-rt0p0-8x8x8`` (the cell
``iaea3d-rt0p0-8x8x8.cold``): it loads, its core is the RT0 6x6x4 file's,
"auto" resolves to "line" at its mesh; rehearsed at its ``rehearsal_mesh``
with the line preconditioner it reads correct and its bfloat16 control
does not; and the arithmetic of its metric ``line_roofline``.
"""

import json
import os

import numpy as np
import pytest
import torch

from neutfem_tpu_torch import krylov, power, tracing
from neutfem_tpu_torch.bench import BenchmarkRun
from neutfem_tpu_torch.data import BENCHMARKS
from neutfem_tpu_torch.fespace import make_fespace
from neutfem_tpu_torch.mesh import CartesianMesh
from portbench import manifest, roofline_line
from portbench.rehearse import rehearse

CELL, CONFIG = "iaea3d-rt0p0-8x8x8.cold", "iaea3d-rt0p0-8x8x8"
SEED = 3000000019
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def line_solves(monkeypatch):
    """The count of line solves the line apply ran (``power.tridiag_solve``
    serves the line preconditioner alone)."""
    n = [0]
    real = power.tridiag_solve

    def spy(*a, **k):
        n[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(power, "tridiag_solve", spy)
    return n


@pytest.mark.parametrize("mode,per_apply", [("line", 1), ("line2", 2), ("jacobi", 0)])
def test_solve_record_counts_the_line_solves(monkeypatch, line_solves, mode, per_apply):
    monkeypatch.setenv("NEUTFEM_PRECOND", mode)
    s = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cpu", dtype=torch.float32).solver
    assert s.preconditioner() == mode
    line_solves[0] = 0
    s.reset_flux()
    s.SolveKeff()
    rec = tracing.recent(1)[0]
    got = rec["counters"].get(power.LINE_APPLIES, 0)
    assert got == line_solves[0]
    # one apply a prologue and one an iteration the blocks ran (one a block here)
    assert got == per_apply * (rec["counters"]["cg.solves"] + rec["counters"]["cg.iterations_run"])
    assert (got > 0) == (per_apply > 0)


@pytest.mark.parametrize("solver,block", [("pcg", None), ("pcg", 4), ("pcg_fused", None),
                                          ("pcg_fused", 3), ("bicgstab", None),
                                          ("bicgstab", 4)])
def test_tallied_preconditioner_counts_every_call(solver, block):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((30, 30))
    A = torch.tensor(a @ a.T / 30 + np.eye(30), dtype=torch.float64)
    b = torch.tensor(rng.standard_normal(30), dtype=torch.float64)
    d = torch.diagonal(A)
    calls = [0]

    def apply(r):
        calls[0] += 1
        tracing.count("test.applies", 3)
        return r / d

    fn = getattr(krylov, solver if block is None else solver + "_blocks")
    kw = {} if block is None else {"block": block}
    with tracing.collect() as c:
        res = fn(lambda v: A @ v, b, torch.zeros_like(b), precond=apply, tol=1e-10, **kw)
    assert res.iterations > 0 and float(res.residual) < 1e-9
    assert calls[0] > 0 and c.record["counters"]["test.applies"] == 3 * calls[0]
    calls[0] = 0
    with tracing.collect() as c:  # wrapped in a composite preconditioner, it still counts
        fn(lambda v: A @ v, b, torch.zeros_like(b), precond=lambda r: 1.0 * apply(r),
           tol=1e-10, **kw)
    assert calls[0] > 0 and c.record["counters"]["test.applies"] == 3 * calls[0]


def _config(name):
    with open(os.path.join(manifest.ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_configuration_loads_with_the_rt0_core_and_resolves_to_line():
    cell = manifest.load_cell(CELL)
    cfg = cell.config
    assert cell.chips == 1 and cell.traffic["name"] == "cold"
    assert cfg["core"] == _config("iaea3d-rt0p0-6x6x4")["core"]
    assert cfg["mesh"] == {"per_assembly": 8, "per_plane": 8} and cfg["reduced"] == []
    assert cfg["facade"]["preconditioner"] == "auto" and cfg["facade"]["env"] == {}
    assert cfg["roofline"] == {"preconditioner": "line"}
    core = cfg["core"]
    n_xy = len(core["plane_types"]["FA"]) * cfg["mesh"]["per_assembly"]
    n_z = len(core["planes_in_z_order"]) * cfg["mesh"]["per_plane"]
    xy = np.linspace(0.0, len(core["plane_types"]["FA"]) * core["pitch_cm"], n_xy + 1)
    z = np.linspace(0.0, len(core["planes_in_z_order"]) * core["pitch_z_cm"], n_z + 1)
    fes = make_fespace(CartesianMesh.from_breaks(xy, xy, z), 0, 0)
    assert fes.mesh.n_elements == 152 ** 3 == 3_511_808
    assert power.resolve_precond(fes, {}, "auto") == "line"
    assert (n_xy, n_z) == (152, 152)


def test_rehearsal_on_the_line_preconditioner_is_correct(monkeypatch):
    monkeypatch.setattr(power, "LINE_MIN_CELLS", 0)  # "auto" -> line at the tiny mesh
    r = rehearse(CELL, SEED)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert tracing.recent(1)[0]["counters"].get(power.LINE_APPLIES, 0) > 0


def test_rehearsal_bfloat16_control_on_the_line_preconditioner_is_not_correct(monkeypatch):
    monkeypatch.setattr(power, "LINE_MIN_CELLS", 0)
    r = rehearse(CELL, SEED + 1, control="bf16")
    assert not r["correct"], r["checks"]
    assert tracing.recent(1)[0]["counters"].get(power.LINE_APPLIES, 0) > 0


def _record(applies, currents, k4_s, outers=(34, 34)):
    recs = [{"outers": o, "counters": {power.LINE_APPLIES: applies // len(outers)},
             "spans": {roofline_line.CURRENT: (currents // len(outers), 0.01)}}
            for o in outers]
    ops = [["elementwise (axpy, scaling, C*v)", 0.5]]
    if k4_s is not None:
        ops.append([roofline_line.K4_FAMILY, k4_s])
    rec = {"config": _config(CONFIG), "shape": [152, 152, 152],
           "trace": {"solves": [{"outers": o, "inners": 1300} for o in outers],
                     "device_ops": ops}}
    return rec, recs


def test_line_roofline_arithmetic(monkeypatch):
    read = manifest.metric_reader("line_roofline")
    n = 152 ** 3
    apply_b = roofline_line.line_apply_bytes(_config(CONFIG), (152, 152, 152))
    assert apply_b == 4 * (4 * n - n / 152)  # r, z, dinv: n a line; l: n - 1
    faces = sum(3 * (n + n / 152) + n for _ in range(3))
    assert roofline_line.current_bytes(_config(CONFIG), (152, 152, 152)) == 2 * 4 * faces
    assert 16.7e-6 < apply_b / 3.35e12 < 16.8e-6  # ~56.1 MB a line solve
    rec, recs = _record(3000, 2, 0.080)
    monkeypatch.setattr(roofline_line, "traced_solves", lambda record: recs)
    monkeypatch.setattr(roofline_line, "device_name", lambda: H100)
    least = (3000 * apply_b + 2 * 2 * 4 * faces) / 3.35e12
    assert read(rec) == pytest.approx(100.0 * least / 0.080, rel=1e-12)
    assert 60.0 < read(rec) < 65.0
    # nothing to read: no K4 time, no line solve (a program without the
    # counter), an unknown card
    assert read(_record(3000, 2, None)[0]) is None
    monkeypatch.setattr(roofline_line, "traced_solves",
                        lambda record: [{**r, "counters": {}} for r in recs])
    assert read(rec) is None
    monkeypatch.setattr(roofline_line, "traced_solves", lambda record: recs)
    monkeypatch.setattr(roofline_line, "device_name", lambda: "some other card")
    assert read(rec) is None


def test_traced_solves_are_the_newest_records():
    for outers in (30, 34, 35):
        with tracing.span(tracing.SOLVE, record="solve"):
            tracing.set_outers(outers)
            tracing.count(power.LINE_APPLIES, outers)
    rec = {"trace": {"solves": [{"outers": 34}, {"outers": 35}]}}
    got = roofline_line.traced_solves(rec)
    assert [r["counters"][power.LINE_APPLIES] for r in got] == [34, 35]
    assert roofline_line.traced_solves({"trace": {"solves": [{"outers": 30}]}}) is None
    assert roofline_line.traced_solves({"trace": None}) is None
