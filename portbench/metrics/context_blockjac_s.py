"""context_blockjac_s: the program's host clock of the block-Jacobi inverse
in the set-up's context builds (the ``neutfem.context.blockjac`` spans of
each sample's build, summed; ``portbench.program_records``).  Nothing to
read where no build made one (P == 1)."""

from portbench.program_records import sample_builds, span_count, span_seconds

SPAN = "neutfem.context.blockjac"


def read(record):
    builds = sample_builds(record)
    if not builds or span_count(builds, SPAN) == 0:
        return None
    return span_seconds(builds, SPAN)
