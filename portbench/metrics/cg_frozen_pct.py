"""cg_frozen_pct: the share of the CG iterations the window's solves launched
that ran after the stop test had failed (a replayed block runs all its
iterations): 100 (``cg.iterations_run`` - ``cg.iterations``) /
``cg.iterations_run`` (``portbench.program_records``)."""

from portbench.program_records import counter, window_solves


def read(record):
    recs = window_solves(record)
    ran = counter(recs, "cg.iterations_run") if recs else 0
    return 100.0 * (ran - counter(recs, "cg.iterations")) / ran if ran else None
