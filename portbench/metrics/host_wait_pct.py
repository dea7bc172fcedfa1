"""host_wait_pct: the share of the window's solves (the program's
``neutfem.solve`` spans) that the host spent waiting on the device inside
its ``neutfem.sync.*`` spans, host clock (``portbench.program_records``)."""

from portbench.program_records import span_seconds, window_solves


def read(record):
    recs = window_solves(record)
    solve_s = span_seconds(recs, "neutfem.solve") if recs else 0.0
    return 100.0 * span_seconds(recs, "neutfem.sync.") / solve_s if solve_s > 0 else None
