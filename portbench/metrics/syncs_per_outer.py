"""syncs_per_outer: the host's waits on the device per power iteration in the
window's solves: the count of the program's ``neutfem.sync.*`` spans (CG
block reads, stop tests, uploads of Python numbers, result reads) over the
solves' outers (``portbench.program_records``)."""

from portbench.program_records import span_count, window_solves


def read(record):
    recs = window_solves(record)
    outers = sum(r["outers"] for r in recs) if recs else 0
    return span_count(recs, "neutfem.sync.") / outers if outers else None
