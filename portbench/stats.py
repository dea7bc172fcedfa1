"""The window's arithmetic: rates and percentiles over the solves it completed."""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["nearest_rank", "window_mean"]


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest value
    with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def window_mean(start: float, end: float, completed: int) -> float:
    """Seconds per completed solve: the window's wall (from its start to the
    end of its last completed solve) over the solves it completed."""
    if completed <= 0:
        raise ValueError("the window completed no solve")
    return (end - start) / completed
