"""Operator layer of neutfem_tpu_torch: context build, matrix-free applies,
and the hand-written CUDA kernels with their plain PyTorch versions."""

from typing import Dict, List, Tuple

__all__ = ["launch_counter", "launch_counters"]

#: Every kernel module's launch counter (its ``LAUNCHES``), in the order the
#: modules were imported.
_COUNTERS: List[Dict[str, int]] = []


def launch_counter(counts: Dict[str, int]) -> Dict[str, int]:
    """Register a kernel module's launch counter (the dict its wrappers add
    one to where they launch a kernel); returns it."""
    _COUNTERS.append(counts)
    return counts


def launch_counters() -> Tuple[Dict[str, int], ...]:
    """Every registered launch counter: what ``krylov.CGGraph`` reads around
    a capture to count its replays' launches."""
    return tuple(_COUNTERS)
