"""outers_per_solve: power iterations per solve, the mean over the window's
completed solves (``GetLastOuterIterations`` after each)."""


def read(record):
    done = [s for s in record["solves"] if s["k"] is not None]
    return sum(s["outers"] for s in done) / len(done) if done else None
