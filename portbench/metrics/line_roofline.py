"""line_roofline: the least time of the K4 launches in the traced solves
(``portbench/roofline_line.py``: the program's count of line solves,
``precond.line_applies``, and three face solves a ``compute_current``, each
at the bytes it must move, over the card's published bandwidth) as a share
of the trace's seconds of the family "tiled Thomas solve (K4)".  Nothing to
read where the program keeps no such count, no line solve ran, or the trace
holds no K4 time."""

from portbench import roofline_line
from portbench.program_records import counter, span_count


def read(record):
    recs = roofline_line.traced_solves(record)
    k4 = dict(record["trace"]["device_ops"]).get(roofline_line.K4_FAMILY) if recs else None
    applies = counter(recs, roofline_line.LINE_APPLIES) if recs else 0
    if not k4 or not applies:
        return None
    least = roofline_line.least_seconds(record["config"], record["shape"],
                                        roofline_line.device_name(), applies,
                                        span_count(recs, roofline_line.CURRENT))
    return 100.0 * least / k4 if least is not None else None
