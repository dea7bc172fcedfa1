"""The per-layer metrics that read the program's own records
(``program_records.py``: ``syncs_per_outer``, ``host_wait_pct``,
``cg_frozen_pct``, ``context_blockjac_s``) on synthetic records: which
records make the window, and each metric's nothing-to-read cases (outers that
do not line up, no trace, no block inverse, a program without records)."""

import sys

import pytest

from portbench import manifest


def _solve(outers, sync_n, sync_s, solve_s, ran, live):
    return {"kind": "solve", "outers": outers,
            "spans": {"neutfem.solve": (1, solve_s), "neutfem.outer": (outers, 0.9 * solve_s),
                      "neutfem.sync.cg_read": (sync_n - outers, 0.6 * sync_s),
                      "neutfem.sync.stop_test": (outers, 0.4 * sync_s)},
            "counters": {"cg.iterations_run": ran, "cg.iterations": live}}


def _build(blockjac_s=None):
    spans = {"neutfem.context.directions": (1, 0.5), "neutfem.build": (1, 30.0)}
    if blockjac_s is not None:
        spans["neutfem.context.blockjac"] = (1, blockjac_s)
    return {"kind": "build", "outers": None, "spans": spans, "counters": {}}


WARMUP = _solve(34, 500, 9.0, 99.0, 4000, 1000)  # older than the window: never read
WINDOW = [_solve(34, 510, 0.1, 0.26, 1200, 1050), _solve(49, 800, 0.5, 1.6, 2400, 2100)]
TRACED = [_solve(34, 515, 0.2, 0.30, 1204, 1050), _solve(49, 805, 0.6, 1.7, 2404, 2100)]


@pytest.fixture
def records(monkeypatch):
    from neutfem_tpu_torch import tracing

    kept = {"solves": [WARMUP] + WINDOW + TRACED, "builds": [_build(14.0), _build(15.5)]}
    monkeypatch.setattr(tracing, "recent", lambda n: kept["solves"][-n:] if n > 0 else [])
    monkeypatch.setattr(tracing, "recent_builds",
                        lambda n: kept["builds"][-n:] if n > 0 else [])
    return kept


def _record(outers=(34, 49), traced=2, samples=(1, 1000000402)):
    return {"solves": [{"outers": o, "k": 1.03, "inners": 1000, "wall_s": 0.3, "sample": 0}
                       for o in outers],
            "trace": None if traced is None else {"solves": [{"outers": 34, "inners": 1}] * traced},
            "traffic": {"xs_sample": {"samples": list(samples)}}}


def read(name, record):
    return manifest.metric_reader(name)(record)


def test_window_metrics_read_the_untraced_window(records):
    rec = _record()
    assert read("syncs_per_outer", rec) == pytest.approx((510 + 800) / (34 + 49))
    assert read("host_wait_pct", rec) == pytest.approx(100 * (0.1 + 0.5) / (0.26 + 1.6))
    assert read("cg_frozen_pct", rec) == pytest.approx(100 * (3600 - 3150) / 3600)


@pytest.mark.parametrize("name", ["syncs_per_outer", "host_wait_pct", "cg_frozen_pct"])
def test_window_metrics_have_nothing_to_read(records, name):
    assert read(name, _record(outers=(49, 34))) is None  # the outers do not line up
    assert read(name, _record(outers=(34, 49, 34))) is None  # misaligned by one record
    assert read(name, _record(traced=None)) is None  # no trace
    assert read(name, _record(traced=1)) is None  # the window shifted: WINDOW[1] is traced
    records["solves"] = WINDOW + TRACED[:1]  # fewer records than solves
    assert read(name, _record()) is None


def test_one_solve_window(records):
    records["solves"] = [WARMUP, WINDOW[1], TRACED[0]]
    assert read("syncs_per_outer", _record(outers=(49,), traced=1)) == pytest.approx(800 / 49)


def test_blockjac_seconds_of_each_samples_build(records):
    assert read("context_blockjac_s", _record()) == pytest.approx(14.0 + 15.5)
    assert read("context_blockjac_s", _record(samples=(1,))) == pytest.approx(15.5)
    records["builds"] = [_build()]  # one sample at P == 1: no block inverse
    assert read("context_blockjac_s", _record(samples=(1,))) is None
    assert read("context_blockjac_s", _record()) is None  # fewer builds than samples


@pytest.mark.parametrize("name", ["syncs_per_outer", "host_wait_pct", "cg_frozen_pct",
                                  "context_blockjac_s"])
def test_a_program_without_records_gives_nothing(monkeypatch, name):
    import neutfem_tpu_torch

    # as in a checkout older than the records: the import fails
    monkeypatch.delattr(neutfem_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "neutfem_tpu_torch.tracing", None)
    assert read(name, _record()) is None
