"""device_idle_pct: the share of the traced solves' wall (the benchmark's
spans around them) in which no operation ran on the card: 100 (1 - the
union of the device intervals / the wall), from the profiler's timeline."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
