"""A later change adds a cell, a traffic mix, a per-layer metric and a
configuration as new files and new entries, and edits no file: the harness
finds them by name."""

import json
import os
import shutil

from portbench import manifest


def test_a_cell_added_from_new_files_loads(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    man = manifest.load_manifest()

    # new files only
    cfg = json.loads((root / "portbench/configs/iaea3d-rt0p0-6x6x4.json").read_text())
    cfg["name"] = "iaea3d-rt0p0-8x8x8"
    cfg["mesh"] = {"per_assembly": 8, "per_plane": 8}
    (root / "portbench/configs/iaea3d-rt0p0-8x8x8.json").write_text(json.dumps(cfg))
    (root / "portbench/limits/iaea3d-rt0p0-8x8x8.json").write_text(
        (root / "portbench/limits/iaea3d-rt0p0-6x6x4.json").read_text())
    traffic = json.loads((root / "portbench/traffic/cold.json").read_text())
    traffic["name"] = "xs-sample"
    (root / "portbench/traffic/xs-sample.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/outers_total.py").write_text(
        "def read(record):\n    return sum(s['outers'] for s in record['solves'])\n")

    # new entries only
    man["configs"].append({"name": "iaea3d-rt0p0-8x8x8", "source": "ANL-7416 Suppl. 2, Problem 11",
                           "file": "portbench/configs/iaea3d-rt0p0-8x8x8.json", "reduced": [],
                           "why": "the line preconditioner"})
    man["workloads"].append({"name": "iaea3d-rt0p0-8x8x8.xs-sample", "config": "iaea3d-rt0p0-8x8x8",
                             "traffic": "xs-sample", "chips": 1, "why": "a new cell"})
    man["per_layer"].append({"name": "outers_total", "unit": "outers", "better": "lower",
                             "source": "program_counter", "layer": "power iteration",
                             "moves": "solve_s", "workloads": ["iaea3d-rt0p0-8x8x8.xs-sample"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.load_cell("iaea3d-rt0p0-8x8x8.xs-sample", root=str(root))
    assert cell.config["mesh"]["per_assembly"] == 8 and cell.traffic["name"] == "xs-sample"
    assert "outers_total" in [m["name"] for m in cell.per_layer]
    read = manifest.metric_reader("outers_total", root=str(root))
    assert read({"solves": [{"outers": 34}, {"outers": 35}]}) == 69
    old = manifest.load_cell("iaea3d-rt0p0-6x6x4.cold", root=str(root))
    assert "outers_total" not in [m["name"] for m in old.per_layer]
    assert all(p.read_bytes() == b for p, b in before.items())
