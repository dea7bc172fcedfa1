"""The port's spans, counters and records (``neutfem_tpu_torch.tracing``), on
the CPU.

The span machinery on its own: nesting and aggregation into every open
record, the records' order and bound, no ``record_function`` without a
profiler and one per span under it.  Then the facade's records against its
own counts on IAEA-3D 1x1x1 at RT0-P0 and RT1-P1: the record's CG iterations
are ``GetLastInnerIterations``, its outers ``GetLastOuterIterations``, the
stop test runs once an outer from the second on plus the stop, every CG host
read is a ``cg_read`` site, and the CG ran as many iterations as it read
(one a block here).  The ``cg.*`` totals keep their meaning after
``tracing.reset_totals`` (``bench.cg_counts`` reads them under their bare
keys), and ``build_seconds`` keeps its keys.
"""

import numpy as np
import pytest
import torch

from neutfem_tpu_torch import krylov, tracing
from neutfem_tpu_torch.bench import BenchmarkRun, cg_counts, reset_cg_counts
from neutfem_tpu_torch.data import BENCHMARKS

F64 = torch.float64


def test_spans_nest_and_aggregate_into_every_open_record():
    with tracing.collect() as outer:
        with tracing.span("t.a"):
            with tracing.collect() as inner:
                with tracing.span("t.b"):
                    tracing.count("t.n", 2)
                with tracing.span("t.b"):
                    pass
        with tracing.sync("site"):
            tracing.count("t.n")
    assert set(inner.record["spans"]) == {"t.b"} and inner.record["spans"]["t.b"][0] == 2
    assert inner.record["counters"] == {"t.n": 2}
    spans = outer.record["spans"]
    assert {k: n for k, (n, _) in spans.items()} == {"t.a": 1, "t.b": 2, "neutfem.sync.site": 1}
    assert spans["t.a"][1] >= spans["t.b"][1] >= 0.0  # t.b ran inside t.a
    assert outer.record["counters"] == {"t.n": 3}
    assert tracing.total("t.n") >= 3


def test_solve_records_close_in_order_and_are_bounded():
    for i in range(tracing.MAX_RECORDS + 3):
        with tracing.span(tracing.SOLVE, record="solve"):
            tracing.set_outers(i)
    got = tracing.recent(3)
    assert [r["outers"] for r in got] == [tracing.MAX_RECORDS, tracing.MAX_RECORDS + 1,
                                          tracing.MAX_RECORDS + 2]
    assert len(tracing.recent(10 * tracing.MAX_RECORDS)) == tracing.MAX_RECORDS
    assert tracing.recent(0) == []
    assert got[-1]["spans"][tracing.SOLVE][0] == 1 and got[-1]["kind"] == "solve"


def test_a_record_closes_when_its_block_raises():
    with pytest.raises(RuntimeError):
        with tracing.span(tracing.SOLVE, record="solve"):
            tracing.set_outers(7)
            raise RuntimeError("boom")
    assert tracing.recent(1)[0]["outers"] == 7
    with tracing.collect() as c:  # nothing is left open
        pass
    assert c.record["spans"] == {}


def test_record_function_only_under_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with tracing.span("t.quiet"):
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("t.loud"):
            torch.ones(4).sum()
    assert made == ["t.loud"]
    assert "t.loud" in [e.name for e in prof.events()]


def test_stats_keep_their_keys_and_meaning_after_reset():
    reset_cg_counts()
    assert cg_counts() == {"solves": 0, "iterations": 0, "host_reads": 0, "replays": 0,
                           "captures": 0, "eager_solves": 0}
    assert tracing.total("cg.iterations_run") == 0
    rng = np.random.default_rng(3)
    a = rng.standard_normal((24, 24))
    A = torch.tensor(a @ a.T / 24 + np.eye(24), dtype=F64)
    b = torch.tensor(rng.standard_normal(24), dtype=F64)
    res = krylov.pcg(lambda v: A @ v, b, torch.zeros_like(b), tol=1e-10)
    blk = krylov.pcg_blocks(lambda v: A @ v, b, torch.zeros_like(b), tol=1e-10, block=4)
    st = cg_counts()
    assert st["solves"] == 2 and st["iterations"] == 2 * res.iterations == 2 * blk.iterations
    reads4 = -(-blk.iterations // 4)
    assert st["host_reads"] == res.iterations + reads4  # one a block: 1 and 4 iterations
    assert st["replays"] == st["captures"] == st["eager_solves"] == 0
    assert tracing.total("cg.iterations_run") == res.iterations + 4 * reads4
    assert st == {k: tracing.total("cg." + k) for k in st}
    with tracing.collect() as c:  # a record open across a reset keeps all it gained
        tracing.count("cg.solves", 2)
        tracing.reset_totals(["cg.solves", "cg.iterations_run"])
        assert tracing.total("cg.solves") == tracing.total("cg.iterations_run") == 0
        tracing.count("cg.solves")
    assert c.record["counters"]["cg.solves"] == 3 and tracing.total("cg.solves") == 1


@pytest.fixture(scope="module", params=[0, 1], ids=["rt0p0", "rt1p1"])
def solved(request):
    run = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cpu", dtype=F64,
                       rt_order=request.param)
    s = run.solver
    build = tracing.recent_builds(1)[0]
    reset_cg_counts()
    s.reset_flux()
    s.SolveKeff()
    return s, build, tracing.recent(1)[0], cg_counts()


def test_solve_record_holds_the_facade_counts(solved):
    s, _, rec, stats = solved
    spans, counters = rec["spans"], rec["counters"]
    outers = s.GetLastOuterIterations()
    assert rec["kind"] == "solve" and rec["outers"] == outers
    assert counters["cg.iterations"] == s.GetLastInnerIterations() == stats["iterations"]
    assert spans["neutfem.sync.stop_test"][0] == outers - 1
    assert spans["neutfem.sync.cg_read"][0] == counters["cg.host_reads"] == stats["host_reads"]
    # one iteration a block on the CPU: every read ran one
    assert counters["cg.iterations_run"] == counters["cg.host_reads"]
    assert counters["cg.solves"] == spans["neutfem.group_solve"][0] == 2 * outers
    assert spans["neutfem.cg.prologue"][0] == counters["cg.solves"]
    assert spans["neutfem.outer"][0] == outers
    assert spans["neutfem.solve"][0] == 1 and spans["neutfem.current"][0] == 1
    assert spans["neutfem.sync.result"][0] == 2
    assert spans["neutfem.sync.upload"][0] > 3 * outers  # tolerances, history, Chebyshev
    assert "neutfem.cg.replay" not in spans and "neutfem.context.directions" not in spans
    assert spans["neutfem.solve"][1] >= spans["neutfem.outer"][1] >= 0.0


def test_build_record_and_build_seconds(solved):
    s, build, _, _ = solved
    assert set(s.build_seconds) == {"context"}
    # line factors at P == 1, the block inverse at P > 1
    names = {k for k in build["spans"]}
    assert names == {"neutfem.build", "neutfem.context.directions", "neutfem.context.schur_diag",
                     "neutfem.context.to_device",
                     "neutfem.context.line" if s._fes.P == 1 else "neutfem.context.blockjac"}
    assert build["kind"] == "build" and build["outers"] is None
    phases = sum(sec for k, (_, sec) in build["spans"].items() if k != "neutfem.build")
    assert phases <= build["spans"]["neutfem.build"][1]


def test_two_grid_build_keeps_its_two_keys(monkeypatch, capsys):
    from neutfem_tpu_torch.compat import VerbosityLevel

    monkeypatch.setenv("NEUTFEM_PRECOND", "twogrid")
    run = BenchmarkRun(BENCHMARKS["iaea2d"], 2, device="cpu", dtype=F64)
    s = run.solver
    assert set(s.build_seconds) == {"context", "twogrid"}
    build = tracing.recent_builds(1)[0]
    assert build["spans"]["neutfem.twogrid.attach"][0] == 1
    # the coarse level's context is built inside the attach
    assert build["spans"]["neutfem.context.directions"][0] == 2
    s.set_verbosity(VerbosityLevel.NORMAL)
    s.BuildMatrices()
    out = capsys.readouterr().out
    assert "operator context staged in" in out and "directions" in out and "line" in out
    assert "two-grid coarse level in" in out
