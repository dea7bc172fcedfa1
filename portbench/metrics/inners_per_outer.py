"""inners_per_outer: CG iterations per power iteration over the window's
completed solves (``GetLastInnerIterations`` over ``GetLastOuterIterations``)."""


def read(record):
    done = [s for s in record["solves"] if s["k"] is not None]
    outers = sum(s["outers"] for s in done)
    return sum(s["inners"] for s in done) / outers if outers else None
