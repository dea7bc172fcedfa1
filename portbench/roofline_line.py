"""The least time of the K4 launches in solves of a configuration that runs
the line preconditioner: the yardstick of ``line_roofline``.

K4 (``thomas_rows_kernel``, the trace family ``K4_FAMILY``) runs there in
two places, and each launch is counted at the bytes it must move, every
operand read once and the answer written once, at the configuration's word
(float32: 4 bytes):

* a line apply (the program's counter ``LINE_APPLIES``, one a line solve):
  along the highest direction's lines of n cells, r read, z written, the
  factors dinv (one a cell) and l (n - 1 a line) read;
* ``compute_current`` (the program's span ``CURRENT``, one a call): one
  solve a direction over every group at once, along the direction's lines
  of n + 1 faces, r read, J written, dinv (one a face) and l (n a line)
  read.

The Thomas sweep's few operations a word leave it bound by bytes, at the
card's published bandwidth (``roofline.PEAKS``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .roofline import PEAKS

__all__ = ["K4_FAMILY", "LINE_APPLIES", "CURRENT", "line_apply_bytes", "current_bytes",
           "least_seconds", "traced_solves", "device_name"]

#: The trace family of K4's launches (``trace.FAMILIES``).
K4_FAMILY = "tiled Thomas solve (K4)"
#: The program's counter of line solves and its span around ``compute_current``.
LINE_APPLIES = "precond.line_applies"
CURRENT = "neutfem.current"

_WORD = {"float32": 4, "float64": 8}


def _dims(shape):
    """The lengths of the mesh's active directions' lines: x, y and, in 3D, z."""
    nz, ny, nx = shape
    return [nx, ny] + ([nz] if nz > 1 else [])


def line_apply_bytes(config: Dict, shape) -> float:
    """Bytes of one line solve along the highest active direction (z in 3D,
    y in 2D) of the (nz, ny, nx) mesh ``shape``."""
    n = _dims(shape)[-1]
    cells = float(shape[0] * shape[1] * shape[2])
    return (4 * cells - cells / n) * _WORD[config["discretization"]["dtype"]]


def current_bytes(config: Dict, shape) -> float:
    """Bytes of one ``compute_current``: a face solve a direction, all groups."""
    cells = float(shape[0] * shape[1] * shape[2])
    words = sum(3 * (cells + cells / n) + cells for n in _dims(shape))
    return config["core"]["ng"] * words * _WORD[config["discretization"]["dtype"]]


def least_seconds(config: Dict, shape, device: str, line_applies: int,
                  currents: int) -> Optional[float]:
    """The least seconds of ``line_applies`` line solves and ``currents``
    calls of ``compute_current`` on ``device``; None for a card the peak
    table lacks."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    total = line_applies * line_apply_bytes(config, shape) + currents * current_bytes(config, shape)
    return total / peak["hbm_bytes_per_s"]


def traced_solves(record: Dict) -> Optional[List[Dict]]:
    """The program's records of the traced solves: the newest T solve
    records, each one's outer count its traced solve's.  None without a
    trace, or where the program keeps no such records."""
    tr = record.get("trace")
    if not tr:
        return None
    try:
        from neutfem_tpu_torch import tracing
    except ImportError:
        return None
    t = len(tr["solves"])
    recs = tracing.recent(t)
    if t == 0 or [r["outers"] for r in recs] != [s["outers"] for s in tr["solves"]]:
        return None
    return recs


def device_name() -> Optional[str]:
    """The name of the card the run used, or None without one."""
    import torch

    return torch.cuda.get_device_name() if torch.cuda.is_available() else None
