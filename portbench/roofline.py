"""The least time one CG iteration of a group solve needs, from the
algorithm's shapes: the yardstick of ``cg_roofline``.

Counted per iteration, float32 (4 bytes) unless the configuration states a
storage: every operand the iteration must read, once, and every vector it
writes, once, whatever kernels implement it, so that a fused or a deleted
kernel leaves the count as it is:

* the factors of each direction's A^-1: the face-tridiagonal solve's
  diagonal and off-diagonal (faces and cells along each line), plus at
  k >= 1 the element coefficient ``alpha`` the condensed bubble term reads;
* the removal term Sigma_r (one value a cell: the mode weights are constants);
* the preconditioner: the Jacobi equilibration (one value a flux DOF); at
  k >= 1 the P x P block of each cell at the configuration's stated storage;
  under the two-grid level the dense coarse inverse at its stated storage,
  and its coarse diagonal;
* the CG vectors x, r and p, each read once and written once.

Operations: per direction and cell, the face pairings, the Thomas sweeps
over the transverse modes and the condensed P x P bubble term; the removal
product, the preconditioner's products, two dots and three updates.  The
bound is the larger of bytes over the bandwidth and operations over the
float32 rate of the card (``PEAKS``, published figures of the SXM part at
700 W).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAKS", "cg_iteration", "bound_seconds"]

#: Published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W), by the
#: name ``torch.cuda.get_device_name`` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}


def cg_iteration(config: Dict, shape) -> Dict[str, float]:
    """Bytes and operations of one CG iteration of one group's solve on the
    (nz, ny, nx) mesh ``shape``."""
    disc = config["discretization"]
    k = disc["rt_order"]
    word = {"float32": 4, "float64": 8}[disc["dtype"]]
    nz, ny, nx = shape
    dim = 3 if nz > 1 else 2
    lengths = [nx, ny] + ([nz] if dim == 3 else [])  # cells along each direction's lines
    N = float(nz * ny * nx)
    P = (k + 1) ** dim
    T = (k + 1) ** (dim - 1)
    pre = config["roofline"]

    words = 0.0
    flops = 0.0
    for n in lengths:
        faces = N + N / n
        words += faces + N           # diagonal (faces) and off-diagonal (n a line)
        if k > 0:
            words += N               # alpha
            flops += (8 * P + 5 * T + 2 * P * P) * N
        else:
            flops += 9 * faces
    words += N                       # Sigma_r
    flops += 2 * P * N
    words += P * N                   # the Jacobi equilibration
    flops += P * N
    extra_bytes = 0.0
    if pre["preconditioner"] == "block":
        extra_bytes += P * P * N * pre["block_bytes_per_entry"]
        flops += 2 * P * P * N
    elif pre["preconditioner"] == "twogrid":
        nc = pre["coarse_cells"]
        extra_bytes += nc * nc * pre["coarse_bytes_per_entry"]
        words += nc
        flops += 2 * nc * nc + 3 * N
    words += 6 * P * N               # x, r, p read and written
    flops += 10 * P * N
    return {"bytes": words * word + extra_bytes, "flops": flops}


def bound_seconds(config: Dict, shape, device_name: str) -> Optional[Dict[str, float]]:
    """The least seconds of one CG iteration on ``device_name`` and which
    bound sets it, or None for a card the table lacks."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    it = cg_iteration(config, shape)
    t_bytes = it["bytes"] / peak["hbm_bytes_per_s"]
    t_flops = it["flops"] / peak["fp32_flops_per_s"]
    return {**it, "seconds": max(t_bytes, t_flops),
            "bound": "bytes" if t_bytes >= t_flops else "flops"}
