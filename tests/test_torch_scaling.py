"""The port's scaling ladder (``neutfem_tpu_torch/scaling.py``) and
``bench.py --full``'s rows (``bench.main_2p6m``, ``main_full``, ``cli``)
against the JAX package on the CPU.

* ``scaling.run_one`` at IAEA-3D 1x1 (19^3 cells) and 1x1x2 (19x19x38, a
  mesh that is not a cube) against ``benchmarks.scaling.run_one`` with the
  JAX package at float64 (``config.set_x64``, as its ``main`` does): |dk| <=
  1e-9, the same outers and cell count, inners within 2; the row's keys are
  the JAX row's without its TPU-only ``axis_perm``, plus the port's device,
  dtype, preconditioner, CG counts, launches and peak memory;
* ``per_doubling`` on ``BENCH_extra.json``'s 8x8x6 -> 8x8x8 rows, and both
  ladders' ``main`` driven with their rows stubbed: the same meshes from the
  default list, the same ``per_doubling`` on every row, the same error on a
  non-square horizontal mesh;
* ``main_2p6m`` at 1x1 on the CPU: the JAX ``iaea3d_2p6M`` row's keys, k of
  the same solve as the ladder's row;
* ``main_full`` with its row functions stubbed: the calls and metric names
  of ``bench.py``'s ``main_full`` in its order, without its two rows of
  typed-in TPU constants; a file only given ``json_path``;
* ``main_accel(json_path=...)`` at a small configuration, and the CLI's
  ``--full`` / ``--accel`` with ``--json``.
"""

import json
import math
import os
import re
import sys

import pytest
import torch

import benchmarks.scaling as j_scaling
from neutfem_tpu import config as j_config
from neutfem_tpu_torch import bench, scaling

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what the port's row carries beyond the JAX row's keys
PORT_KEYS = {"keff_unrounded", "device", "dtype", "preconditioner", "cg", "launches",
             "peak_mem_gb"}


@pytest.fixture(scope="module")
def ladder_rows():
    """(JAX row, port row) of IAEA-3D 1x1 and 1x1x2, float64."""
    j_config.set_x64(True)
    return {(n, nz): (j_scaling.run_one(n, nz),
                      scaling.run_one(n, nz, device="cpu", dtype=F64))
            for n, nz in ((1, 1), (1, 2))}


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2)], ids=["1x1x1", "1x1x2"])
def test_run_one_matches_jax(ladder_rows, mesh):
    want, got = ladder_rows[mesh]
    assert set(got) == (set(want) - {"axis_perm"}) | PORT_KEYS
    assert got["mesh"] == want["mesh"] == "{0}x{0}x{1}".format(*mesh)
    assert got["n_cells"] == want["n_cells"] == 19 * 19 * 19 * mesh[1]
    assert abs(got["keff"] - want["keff"]) <= 1e-9  # both rounded to 7 digits
    assert round(got["keff_unrounded"], 7) == got["keff"]
    assert got["outers"] == want["outers"]
    assert abs(got["inners"] - want["inners"]) <= 2
    assert got["dtype"] == "torch.float64" and got["device"] == "cpu"
    assert got["preconditioner"] == "jacobi" and got["peak_mem_gb"] is None
    # K1-K4 have no launches on the CPU; the timed solve's CG counts are its own
    assert got["launches"] == {} and got["cg"]["iterations"] == got["inners"]
    assert got["s_per_outer"] > 0 and got["wall_s"] > 0


def test_per_doubling_matches_the_jax_formula():
    rows = {r["metric"]: r for r in json.load(open(os.path.join(REPO, "BENCH_extra.json")))}
    a, b = (rows[f"iaea3d_{m}_seconds_per_outer_iteration"] for m in ("2p6M", "3p5M"))
    prev = {"n_cells": a["detail"]["n_cells"], "s_per_outer": a["value"]}
    row = {"n_cells": b["detail"]["n_cells"], "s_per_outer": b["value"]}
    assert (prev["n_cells"], row["n_cells"]) == (2633856, 3511808)
    assert (prev["s_per_outer"], row["s_per_outer"]) == (0.014358, 0.037253)
    jax_formula = round((0.037253 / 0.014358) ** (1.0 / math.log2(3511808 / 2633856)), 3)
    assert scaling.per_doubling(prev, row) == jax_formula == 9.946
    assert scaling.per_doubling(dict(prev, s_per_outer=0.0), row) is None


def _stub_rows(calls):
    """A ``run_one`` stand-in that records its meshes and returns rows whose
    time grows with the cell count."""
    def run_one(n, nz, **kw):
        calls.append((n, nz))
        cells = (19 * n) ** 2 * 19 * nz
        return {"mesh": f"{n}x{n}x{nz}", "n_cells": cells, "s_per_outer": 1e-9 * cells ** 1.2}
    return run_one


def test_ladder_main_matches_jax(monkeypatch, capsys):
    """Both ``main``s with their rows stubbed: the default mesh list, the rows
    in order with the same ``per_doubling``; ``2x3x2`` refused alike."""
    monkeypatch.setattr(j_config, "set_x64", lambda enabled: None)
    j_calls, t_calls = [], []
    monkeypatch.setattr(j_scaling, "run_one", _stub_rows(j_calls))
    monkeypatch.setattr(scaling, "run_one", _stub_rows(t_calls))
    monkeypatch.setattr(sys, "argv", ["scaling"])
    j_scaling.main()
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = scaling.main([])
    assert scaling.DEFAULT_MESHES == "2x2x2,4x4x3,6x6x4,8x8x6,8x8x8"
    assert t_calls == j_calls == [(2, 2), (4, 3), (6, 4), (8, 6), (8, 8)]
    assert got == want and "per_doubling" not in got[0]
    # the stub's time grows as cells^1.2: 2^1.2 a doubling
    assert all(r["per_doubling"] == pytest.approx(2 ** 1.2, abs=1e-3) for r in got[1:])
    monkeypatch.setattr(sys, "argv", ["scaling", "--meshes", "2x3x2"])
    with pytest.raises(SystemExit) as j_err:
        j_scaling.main()
    with pytest.raises(SystemExit) as t_err:
        scaling.main(["--meshes", "2x3x2"])
    assert str(t_err.value) == str(j_err.value) and "must be square" in str(t_err.value)
    assert len(j_calls) == 5  # refused before any row


#: ``bench.py``'s ``main_full`` rows that are typed-in TPU constants
TPU_CONSTANT_ROWS = ("twogrid_precond_adjudication", "sharded_1device_mesh_real_tpu")


def _jax_full_metrics():
    """The metric names of ``bench.py``'s ``main`` and ``main_full`` rows, in
    the order the source lists them (its order of execution)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    names = re.findall(r'"(\w+_seconds_per_outer_iteration|twogrid_precond_adjudication|'
                       r'sharded_1device_mesh_real_tpu)"', src)
    return list(dict.fromkeys(names))


def test_main_2p6m_row_on_the_cpu(ladder_rows):
    """The 8x8x6 row's function at 1x1: the JAX row's detail keys less
    ``axis_perm``, and the ladder row's k (the same two solves)."""
    out = bench.main_2p6m(1, 1, device="cpu", dtype=F64)
    assert out["metric"] == "iaea3d_2p6M_seconds_per_outer_iteration" and out["unit"] == "s/outer"
    assert set(out["detail"]) == {"keff", "pcm", "n_cells", "outer_iterations",
                                  "inner_iterations", "solve_wall_s", "mesh", "cg", "device",
                                  "dtype", "preconditioner"}
    row = ladder_rows[(1, 1)][1]
    assert out["detail"]["keff"] == row["keff"] and out["detail"]["mesh"] == "1x1x1"
    assert (out["detail"]["outer_iterations"], out["detail"]["inner_iterations"]) == (
        row["outers"], row["inners"])


def test_main_full_runs_the_jax_rows_in_order(monkeypatch, tmp_path):
    calls = []

    def stub(name, metric):
        def row(*args, **kw):
            calls.append((name, args, kw))
            return {"metric": metric(*args), "value": 1.0, "unit": "s/outer"}
        return row

    monkeypatch.setattr(bench, "main", stub("main", lambda *a: "iaea3d_seconds_per_outer_iteration"))
    monkeypatch.setattr(bench, "main_ho", stub(
        "main_ho", lambda k: f"iaea3d_rt{k}p{k}_seconds_per_outer_iteration"))
    monkeypatch.setattr(bench, "main_2p6m", stub(
        "main_2p6m", lambda: "iaea3d_2p6M_seconds_per_outer_iteration"))
    monkeypatch.setattr(bench, "main_scale", stub(
        "main_scale", lambda: "iaea3d_3p5M_seconds_per_outer_iteration"))
    monkeypatch.setattr(bench, "main_2d", stub("main_2d", lambda c, n: bench.CORES_2D[c]))
    monkeypatch.setattr(bench, "main_adjoint", stub(
        "main_adjoint", lambda: "iaea3d_adjoint_seconds_per_outer_iteration"))
    monkeypatch.chdir(tmp_path)
    rows = bench.main_full(device="cpu")
    want = [m for m in _jax_full_metrics() if m not in TPU_CONSTANT_ROWS]
    assert len(want) == 8 and [r["metric"] for r in rows] == want
    assert [(n, a) for n, a, _ in calls] == [
        ("main", (6, 4)), ("main_ho", (1,)), ("main_ho", (2,)), ("main_2p6m", ()),
        ("main_scale", ()), ("main_2d", ("koeberg2d", 32)), ("main_2d", ("zion2d", 48)),
        ("main_adjoint", ())]
    assert all(kw == {"device": "cpu"} for _, _, kw in calls)
    assert os.listdir(tmp_path) == []  # no file without a path
    path = tmp_path / "full.json"
    rows = bench.main_full(json_path=str(path), device="cpu")
    assert json.loads(path.read_text()) == rows


def test_cli_json_goes_to_full_and_accel(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(bench, "main_full", lambda json_path=None: seen.append(("full", json_path)))
    monkeypatch.setattr(bench, "main_accel", lambda json_path=None: seen.append(("accel",
                                                                                 json_path)))
    bench.cli(["--full"])
    bench.cli(["--full", "--json", "f.json"])
    bench.cli(["--accel", "--json", "a.json"])
    assert seen == [("full", None), ("full", "f.json"), ("accel", "a.json")]
    with pytest.raises(SystemExit):
        bench.cli(["--json", "x.json"])  # --json needs --full or --accel
    assert not any(tmp_path.iterdir())


def test_main_accel_writes_its_rows(tmp_path):
    """``accel_compare.py --json``: the file holds the rows ``main_accel``
    returns (IAEA-2D 1x1, one accelerator, on the CPU)."""
    path = tmp_path / "accel.json"
    rows = bench.main_accel(configs=(("iaea2d", dict(mesh_n=1), (1e-6, 1e-5, 1e-5, 600, 1000)),),
                            accels=("chebyshev",), device="cpu", dtype=F64, json_path=str(path))
    assert len(rows) == 1 and rows[0]["core"] == "iaea2d" and rows[0]["accel"] == "chebyshev"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rows))
