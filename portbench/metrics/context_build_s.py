"""context_build_s: the program's own host clock of its context build, the
context and (ZION) the two-grid level summed (``NeutFEM.build_seconds``)."""


def read(record):
    b = record.get("build_seconds") or {}
    return sum(b.values()) if b else None
