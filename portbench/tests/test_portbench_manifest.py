"""BENCHMARK.json against the rules of its format, and the harness finding
every cell's files by name."""

import json
import os
import re

import pytest

from portbench import manifest

ROOT = manifest.ROOT
MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert not any(p.endswith("_torch") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [e["name"] for e in MAN[group]]
        assert len(entries) == len(set(entries)), group
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_metrics_of_every_cell():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert {"setup_s", "solve_s", "solve_p90_s"} <= e2e
    assert next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for w in MAN["workloads"]:
        cell = manifest.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_every_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            target = e2e[m["moves"]]
            assert "workloads" not in target or cell in target["workloads"], (m["name"], cell)


def test_files_found_by_name_and_under_paths():
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "limits", c["name"] + ".json"))
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for w in MAN["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    for m in MAN["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_cells_use_every_config_and_at_most_a_quarter_take_four_chips():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_run_seconds_fit_the_full_check():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_load_cell(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1 and c.config["reduced"] == []
    assert {"k_gap", "fick_res", "balance_res"} <= set(c.limits)
    assert c.limits["k_gap"]["limit"] and c.limits["fick_res"]["limit"]
