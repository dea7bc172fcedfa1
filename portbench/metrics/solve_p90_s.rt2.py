"""solve_p90_s.rt2: the 90th percentile (nearest rank) of the window's solve
walls of the mix's sample whose solves take the most outers, RT2-P2's second
outer basin (host clock, the untraced window).  Nothing to read where the
mix has one sample."""

from portbench.stats import nearest_rank


def read(record):
    done = [s for s in record["solves"] if s["k"] is not None]
    samples = sorted({s["sample"] for s in done})
    if len(samples) < 2:
        return None
    slow = max(samples, key=lambda j: max(s["outers"] for s in done if s["sample"] == j))
    return nearest_rank([s["wall_s"] for s in done if s["sample"] == slow], 90)
