"""On the card, at each cell's own size: a short run is correct, and the
controls of the check are not (``study.py`` on three seeds).  Skipped
without a card; run them on the card with

    python3 -m pytest portbench/tests/test_portbench_card.py -m gpu -q
"""

import json
import subprocess
import sys

import pytest

from portbench import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "solve_s", "solve_p90_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_the_check_at_full_size(card, cell):
    from portbench.study import study_seed

    c = manifest.load_cell(cell)
    lim = {k: v["limit"] for k, v in c.limits.items()
           if isinstance(v, dict) and v.get("limit") is not None}
    for seed in (4000000001, 4000000002, 4000000003):
        r = study_seed(c, seed, tf32=False)
        assert all(r["program"][k] <= lim[k] for k in lim), r
        assert any(r["bf16"][k] > lim[k] for k in lim), r
        assert any(r["unchanged"][k] > lim[k] for k in lim), r
