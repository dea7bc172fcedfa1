"""ms_per_outer: the window's solve wall times (host clock, each ending in a
read of k) over their power iterations, from the untraced solves."""


def read(record):
    done = [s for s in record["solves"] if s["k"] is not None]
    outers = sum(s["outers"] for s in done)
    return 1e3 * sum(s["wall_s"] for s in done) / outers if outers else None
