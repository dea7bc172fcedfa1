"""The harness's own arithmetic: percentiles and the window, the trace
reduction, the roofline's pinned counts, the whole-name import guard."""

import json
import os

import pytest

from portbench import manifest, roofline, stats, trace
from portbench.guard import forbidden_modules


def test_nearest_rank_percentile():
    walls = [float(i) for i in range(1, 101)]  # 1..100
    assert stats.nearest_rank(walls, 90) == 90.0
    assert stats.nearest_rank(list(reversed(walls)), 90) == 90.0
    assert stats.nearest_rank([5.0], 90) == 5.0
    assert stats.nearest_rank([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0], 90) == 10.0
    with pytest.raises(ValueError):
        stats.nearest_rank([], 90)


def test_window_mean():
    assert stats.window_mean(10.0, 40.5, 100) == pytest.approx(0.305)
    with pytest.raises(ValueError):
        stats.window_mean(0.0, 1.0, 0)


def test_timeline_union_gaps_and_labels():
    device = [(10, 20, "elementwise_kernel"), (15, 30, "fused_rows_kernel<float>"),
              (50, 60, "reduce_kernel"), (95, 120, "Memcpy DtoH"), (-5, 2, "elementwise_kernel")]
    host = [(0, 100, "portbench.SolveKeff"), (30, 50, "cudaStreamSynchronize"),
            (60, 95, "aten::item"), (70, 80, "cudaLaunchKernel")]
    r = trace.reduce_timeline(device, host, (0, 100))
    assert r["launches"] == 4  # the one that starts before the window is out
    assert r["busy_s"] == pytest.approx((2 + 20 + 10 + 5) / 1e6)
    assert r["window_s"] == pytest.approx(100 / 1e6)
    idle = dict(r["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(35e-6)  # the innermost host event
    assert idle["portbench.SolveKeff"] == pytest.approx(8e-6)
    assert "aten::item" not in idle
    ops = dict(r["device_ops"])
    assert ops["copies"] == pytest.approx(5e-6)
    assert ops["tiled fused Schur directions y, x (K2, K3)"] == pytest.approx(15e-6)


def test_families_copy_the_program_table():
    assert trace.family("void fused_ho_rows_kernel<2>(...)") == "tiled condensed Schur directions (K6)"
    assert trace.family("blockjac_dev_kernel") .endswith("(K8, default)")
    assert trace.family("something_new") == "other"


def _config(name):
    with open(os.path.join(manifest.ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,shape,bytes_,flops", [
    ("iaea3d-rt0p0-6x6x4", (76, 114, 114), 55432272.0, 39780756.0),
    ("iaea3d-rt2p2-4x4x2", (38, 76, 76), 334765408.0, 1528953408.0),
    ("zion2d-rt0p0-48x48", (1, 912, 912), 106678464.0, 95020064.0),
])
def test_cg_iteration_counts_pinned(name, shape, bytes_, flops):
    it = roofline.cg_iteration(_config(name), shape)
    assert it == {"bytes": bytes_, "flops": flops}
    b = roofline.bound_seconds(_config(name), shape, "NVIDIA H100 80GB HBM3")
    assert b["bound"] == "bytes" and b["seconds"] == pytest.approx(bytes_ / 3.35e12)
    assert roofline.bound_seconds(_config(name), shape, "some other card") is None


def test_guard_compares_whole_top_level_names():
    loaded = ["neutfem_tpu_torch", "neutfem_tpu_torch.ops.apply", "numpy", "jaxtyping",
              "neutfem_tpu_tools"]
    assert forbidden_modules(loaded) == []
    assert forbidden_modules(loaded + ["neutfem_tpu"]) == ["neutfem_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "benchmarks.data",
                              "neutfem._neutfem_eigen"]) == sorted(
        ["jax.numpy", "jaxlib", "flax.linen", "benchmarks.data", "neutfem._neutfem_eigen"])


def test_slow_basin_p90_reads_the_sample_with_most_outers():
    read = manifest.metric_reader("solve_p90_s.rt2")
    solves = [{"sample": j % 2, "outers": 49 if j % 2 == 0 else 64, "wall_s": 1.5 + 0.4 * (j % 2)
               + 0.001 * j, "k": 1.03, "inners": 2000} for j in range(20)]
    assert read({"solves": solves}) == pytest.approx(1.9 + 0.001 * 17)
    assert read({"solves": [s for s in solves if s["sample"] == 0]}) is None
    solves[1]["k"] = None  # a failed solve is no reading: 9 left, the 9th
    assert read({"solves": solves}) == pytest.approx(1.9 + 0.001 * 19)
