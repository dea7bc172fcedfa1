"""Partitioned (substructured) tridiagonal solve for the CUT direction of a
multi-device solve (port of ``neutfem_tpu/ops/parttri.py``).

Each rank owns a contiguous segment of every mesh line along the cut axis —
an even slab: n/p cells and the n/p body faces k·s … k·s+s−1 — and the seam
face n, which closes the last segment, sits on every rank as a (p+1)-th
segment of size 1.  The removed inter-segment couplings form a rank-2p
Woodbury correction

    T = T_hat + U V^T,   x = y - T_hat^{-1} U M^{-1} V^T y,   y = T_hat^{-1} d,

whose ingredients are solve constants made once on the host
(``build_partitioned``, numpy float64, cast to the working dtype when a rank's
context is placed): the per-segment LDL^T factors, the coupling-scaled unit
load solutions T_hat^{-1} e_first / e_last, and the inverse of the (2p x 2p
per line) interface matrix M = I + V^T T_hat^{-1} U.  Pinned faces need no
special case: the context factors them with diag 1 / coupling 0.

Per application (``tridiag_solve_partitioned``): the segment's Thomas solve
(K4, or K4′ at its layout, through ``ops/tridiag.tridiag_solve``), the seam
solve (one multiply), ONE all-gather of each segment's first and last solution planes
(and the seam's), the 2p x 2p interface product with ``minv`` per line and
the two rank-1 corrections.  ``partitioned_schur_dir`` wraps it into the
cut direction's B_d A_d^{-1} B_d^T v: it sends one face-rhs plane to the next
rank (the c1 term of its first face) and one solution plane to the previous
rank (the divergence of its last cell).

The JAX package keeps its face arrays in GSPMD's ceil sharding and realigns
them with ``ppermute`` block hops (``neutfem_tpu/ops/parttri.py:310-352``);
here a rank holds the even slab from the start (``parallel.shard_context``),
so that realignment has no counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..shardctx import seam_faces
from . import launch_counter
from .apply import _const, _face_out, _pair
from .tridiag import tridiag_solve

__all__ = ["build_partitioned", "tridiag_solve_partitioned", "partitioned_face_solve",
           "partitioned_schur_dir", "PART_NAMES", "LAUNCHES"]

PART_NAMES = ("dinv", "l", "vrs", "vls", "minv", "seamd", "seamc")

#: Applications of the cut direction's face solve (``"parttri"``, one per
#: cut direction per matvec or ``compute_current``; the partitioned solve,
#: or the elementwise one under "diag" / "lumped"): the engagement count the
#: tests read.  It counts applications, not kernels (the exact solve
#: launches K4);
#: a launch counter, so a CG graph's replay adds its capture's applications.
LAUNCHES = launch_counter({"parttri": 0})


def _ldlt_np(a: np.ndarray, b: np.ndarray):
    """Batched LDL^T of SPD tridiagonals along the LAST axis (host, tiny s)."""
    d = [a[..., 0]]
    ls = []
    for i in range(b.shape[-1]):
        li = b[..., i] / d[-1]
        ls.append(li)
        d.append(a[..., i + 1] - b[..., i] * li)
    dinv = 1.0 / np.stack(d, axis=-1)
    l = (np.stack(ls, axis=-1) if ls
         else np.zeros(a.shape[:-1] + (0,), a.dtype))
    return dinv, l


def _solve_np(dinv: np.ndarray, l: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Batched LDL^T solve along the LAST axis (host)."""
    s = r.shape[-1]
    z = [r[..., 0]]
    for i in range(1, s):
        z.append(r[..., i] - l[..., i - 1] * z[-1])
    w = [zi * dinv[..., i] for i, zi in enumerate(z)]
    x = [None] * s
    x[-1] = w[-1]
    for i in range(s - 2, -1, -1):
        x[i] = w[i] - l[..., i] * x[i + 1]
    return np.stack(x, axis=-1)


def build_partitioned(dinv, l, fax: int, p: int) -> Optional[Dict[str, np.ndarray]]:
    """Host-side constants for the partitioned solve of one direction.

    dinv, l: the GLOBAL LDL^T factors from the context (any leading batch dims;
    the face axis is ``fax``), m = n+1 faces with the body n divisible by p.
    Returns {name: array} with the face axis back at ``fax`` for body-shaped
    arrays, or None when the direction does not partition (n % p != 0, or
    fewer than 2 faces per segment).  ``l`` comes back padded with one dummy
    0 per segment (s entries a segment), as in the JAX package.
    """
    dinv = np.asarray(dinv, np.float64)
    l = np.asarray(l, np.float64)
    m = dinv.shape[fax]
    n = m - 1
    if n % p or n // p < 2:
        return None
    s = n // p

    dv = np.moveaxis(dinv, fax, -1)  # (..., m)
    lv = np.moveaxis(l, fax, -1)     # (..., n)

    # reconstruct the original tridiagonal (a, b) — exact: pinned faces are
    # factored with diag 1 / coupling 0 in the context, so no zero pivots
    d = 1.0 / dv
    b = lv * d[..., :-1]
    a = d.copy()
    a[..., 1:] += b * lv

    batch = a.shape[:-1]
    a_seg = a[..., :n].reshape(*batch, p, s)
    b_all = b.reshape(*batch, p, s)          # last entry of each row = interface
    b_int = b_all[..., : s - 1]              # internal couplings
    b_ifc = b_all[..., s - 1]                # (..., p) right-interface coupling

    dinv_loc, l_loc = _ldlt_np(a_seg, b_int)             # (..., p, s) / (..., p, s-1)

    eye0 = np.zeros(a_seg.shape, a.dtype)
    eye0[..., 0] = 1.0
    eyeL = np.zeros(a_seg.shape, a.dtype)
    eyeL[..., -1] = 1.0
    vL = _solve_np(dinv_loc, l_loc, eye0)                # T_k^-1 e_first
    vR = _solve_np(dinv_loc, l_loc, eyeL)                # T_k^-1 e_last

    # coupling-scaled correction vectors (zero left coupling for segment 0)
    vrs = b_ifc[..., None] * vR
    b_left = np.concatenate(
        [np.zeros_like(b_ifc[..., :1]), b_ifc[..., :-1]], axis=-1)
    vls = b_left[..., None] * vL

    a_seam = a[..., n]
    seamd = 1.0 / a_seam                                  # (...,)
    seamc = b[..., n - 1] * seamd                         # b_{n-1} / a_n

    # interface matrix M = I + V^T T_hat^{-1} U  (2p x 2p per line)
    M = np.zeros(batch + (2 * p, 2 * p), a.dtype)
    idx = np.arange(2 * p)
    M[..., idx, idx] = 1.0
    for i in range(p):
        # column 2i: support segment i, vector vrs[..., i, :]
        M[..., 2 * i + 1, 2 * i] += vrs[..., i, s - 1]
        if i >= 1:
            M[..., 2 * (i - 1), 2 * i] += vrs[..., i, 0]
        # column 2i+1: support segment i+1 (or the seam for i = p-1)
        if i < p - 1:
            w0 = vls[..., i + 1, 0]
            wl = vls[..., i + 1, s - 1]
            M[..., 2 * i, 2 * i + 1] += w0
            M[..., 2 * (i + 1) + 1, 2 * i + 1] += wl
        else:
            M[..., 2 * (p - 1), 2 * (p - 1) + 1] += seamc
    minv = np.linalg.inv(M)

    def back(x):  # (..., p, s) -> body layout with face axis at fax
        return np.moveaxis(x.reshape(*batch, n), -1, fax)

    l_pad = np.concatenate(
        [l_loc, np.zeros(batch + (p, 1), a.dtype)], axis=-1)  # dummy 0 per segment

    return {
        "dinv": back(dinv_loc),
        "l": back(l_pad),
        "vrs": back(vrs),
        "vls": back(vls),
        "minv": minv,                  # (batch_without_fax..., 2p, 2p)
        "seamd": np.expand_dims(seamd, fax),
        "seamc": np.expand_dims(seamc, fax),
    }


def tridiag_solve_partitioned(rb, rs, part: Dict, axis: int, tr):
    """One rank's share of the partitioned solve T x = rhs along the cut
    ``axis`` (the JAX ``_segments_solve``; its wrapper
    ``tridiag_solve_partitioned`` only adds the ceil <-> even realignment).

    rb: the rank's body segment rhs (..., T, s faces along ``axis``, ...);
    rs: the seam face rhs (the same with 1 face; used from the last rank
    only); ``part``: the rank's bundle (``parallel.shard_context``): dinv,
    vrs, vls with s faces and l with s-1 (no T axis), seamd / seamc with 1
    face, minv (lines..., 2p, 2p) over the two other spatial dims; ``tr``:
    the transport of the cut axis's process group (``shardctx.Transport``).
    Returns (x_body, x_seam)."""
    axis = axis % rb.ndim
    s = rb.shape[axis]
    p, k = tr.size, tr.rank
    y = tridiag_solve(rb, part["dinv"].unsqueeze(-4), part["l"].unsqueeze(-4), axis)
    y_n = rs * part["seamd"].unsqueeze(-4)                     # the seam solve
    # one all-gather: every segment's first and last solution plane, and the
    # seam solution (the last rank's)
    g = tr.all_gather(torch.stack([y.select(axis, 0), y.select(axis, s - 1),
                                   y_n.select(axis, 0)]))      # (p, 3, plane...)
    rows = []
    for i in range(p):
        rows.append(g[i + 1, 0] if i < p - 1 else g[p - 1, 2])  # V^T y row 2i
        rows.append(g[i, 1])                                   # row 2i+1
    vty = torch.stack(rows, dim=-1)                            # (plane..., 2p)
    # alpha = minv vty per line; minv gains the T axis of the planes
    alpha = torch.matmul(part["minv"].unsqueeze(-5), vty.unsqueeze(-1)).squeeze(-1)
    a_r = alpha[..., 2 * k].unsqueeze(axis)
    a_l = alpha[..., max(2 * k - 1, 0)].unsqueeze(axis)
    x = y - a_r * part["vrs"].unsqueeze(-4) - a_l * part["vls"].unsqueeze(-4)
    x_seam = y_n - alpha[..., 2 * p - 1].unsqueeze(axis) * part["seamc"].unsqueeze(-4)
    return x, x_seam


def partitioned_face_solve(di, L, R, ctx: Dict, key: str, tr):
    """The cut direction's masked, m_t-scaled A-solve on a rank's faces
    (``solve_A_dir``'s semantics): the face rhs of face j is L_j + R_{j-1}
    (L, R: the left- and right-face contributions of the rank's cells, (...,
    T, s cells along the axis, ...); face 0 takes the previous rank's last R
    plane, one plane sent), the seam's is the last rank's last R.  The exact
    A solves by the partitioned method (the ``tri_part_*`` bundle); under
    "diag" / "lumped" (no bundle) each face is its own system, x =
    rhs * ``tri_dinv``, on the body faces and the seam alike, so no
    interface exchange is needed.  Returns the rank's s+1 faces' solution:
    its s body faces and the face that closes its slab (the next rank's
    first face, one plane sent, or the seam on the last rank)."""
    LAUNCHES["parttri"] += 1
    axis = (di.axis - 3) % L.ndim
    s = L.shape[axis]
    m_t = _const(di.m_t, L).reshape(-1, 1, 1, 1)
    mb, ms = ctx[f"mask_{key}"], ctx[f"mask_{key}__seam"]
    prev = tr.shift(R.narrow(axis, s - 1, 1), +1)
    rb = L + torch.cat([prev, R.narrow(axis, 0, s - 1)], dim=axis)
    rs = R.narrow(axis, s - 1, 1)
    if f"tri_part_dinv_{key}" in ctx:
        part = {nm: ctx[f"tri_part_{nm}_{key}"] for nm in PART_NAMES}
        x, x_seam = tridiag_solve_partitioned(rb * mb / m_t, rs * ms / m_t, part, axis, tr)
    else:
        x = rb * mb / m_t * ctx[f"tri_dinv_{key}"].unsqueeze(-4)
        x_seam = rs * ms / m_t * ctx[f"tri_dinv_{key}__seam"].unsqueeze(-4)
    return seam_faces(x * mb, x_seam * ms, axis, tr)


def partitioned_schur_dir(fes, di, v, ctx: Dict, key: str, tr, BXt):
    """The whole cut-direction Schur contribution B_d A_d^{-1} B_d^T v of a
    rank's slab (the JAX ``partitioned_schur_dir``): face rhs, partitioned
    solve, divergence, with the semantics of the unfused chain (``_face_rhs``
    -> masked, m_t-scaled ``solve_A_dir`` -> mask -> ``_face_out``).  BXt is a
    host (2+, P, T) pairing tensor: ``di.BXc`` for the condensed chain,
    ``di.BX[:2]`` for RT0.  ``fes`` is unused (the JAX signature's)."""
    F = partitioned_face_solve(di, _pair(v, BXt[0]), _pair(v, BXt[1]), ctx, key, tr)
    return _face_out(di, F, BXt)
