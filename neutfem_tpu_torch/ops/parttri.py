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

Where the JAX package attaches no bundle — a PERIODIC cut direction, a
segment of one face, ``NEUTFEM_PARTTRI=0`` — it solves the cut direction by
the GSPMD-partitioned associative scan (``neutfem_tpu/ops/apply.py:211-259``).
``tridiag_solve_scan`` is that solve with GSPMD's carries written out: each
rank composes the affine maps of its own faces at log depth
(``ops/tridiag.affine_pairs``), one all-gather a sweep brings every rank's
composed pair, and each rank folds those of the ranks before it (after it,
backward) into its carry; on a PERIODIC direction the tied face is folded
into face 0 across the ring and the Sherman-Morrison correction takes one
more all-gather.  No TPU kernel runs there, so no CUDA kernel does here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import tracing
from ..shardctx import seam_faces
from .apply import _const, _face_out, _pair, cyc_args
from .tridiag import affine_pairs, tridiag_solve

__all__ = ["build_partitioned", "tridiag_solve_partitioned", "tridiag_solve_scan",
           "partitioned_face_solve", "partitioned_schur_dir", "PART_NAMES"]

PART_NAMES = ("dinv", "l", "vrs", "vls", "minv", "seamd", "seamc")

#: ``tracing``'s counters of the cut direction's face solve, one a cut
#: direction a matvec or ``compute_current``: the partitioned solve (or the
#: elementwise one under "diag" / "lumped") and the scan solve
#: (``tridiag_solve_scan``), the engagement counts the tests read.  They
#: count applications, not kernels (the partitioned solve launches K4); a CG
#: graph's replay counts its capture's applications again.
PARTTRI, SCAN = "parttri.parttri", "parttri.scan"


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


def _carry(A, B, axis: int, tr, first: bool):
    """The carry of this rank's sweep: every rank's composed pair at its end
    plane (``first``: its first face, for the backward sweep; else its last
    face) in one all-gather, and those of the ranks before it (after it,
    backward) folded in rank order from a zero carry at the domain's end."""
    n = B.shape[axis]
    end = 0 if first else n - 1
    b = B.narrow(axis, end, 1)
    g = tr.all_gather(torch.stack([A.narrow(axis, end, 1).expand_as(b), b]))
    c = torch.zeros_like(b)
    for j in (range(tr.size - 1, tr.rank, -1) if first else range(tr.rank)):
        c = g[j, 0] * c + g[j, 1]
    return c


def tridiag_solve_scan(rb, rs, dinv, l, axis: int, tr, cyclic=None):
    """One rank's share of the scan solve of T x = rhs along the cut
    ``axis`` (the JAX ``_scan_solve`` under GSPMD): the forward recurrence
    z_j = r_j - l_{j-1} z_{j-1}, w = z * dinv, the backward one x_j = w_j -
    l_j x_{j+1}, each composed over the rank's faces with a zero carry-in,
    then the carry from the other ranks (one all-gather a sweep) applied as
    z = A c + B.

    rb: the rank's body rhs (..., T, s faces along ``axis``, ...); rs: the
    seam face's rhs (1 face), scanned by the last rank as its (s+1)-th face,
    or None where the direction has no seam (PERIODIC); dinv: (the body's s
    pivots, the seam's or None), l: (the coupling into the slab's first face
    (0 on rank 0), the s couplings of the body faces to their next face (the
    last to the next rank's first face, the seam, or 0 at a PERIODIC
    direction's end)), each broadcasting against rb.  ``cyclic``: (wt, a0,
    a1) of a PERIODIC direction (``cyc_args``, the rank's slab): the
    Sherman-Morrison correction x - wt (a0 y_0 + a1 y_{n-1}) of the folded
    system, y_0 from rank 0 and y_{n-1} from the last rank in one more
    all-gather.  ``tr``: the cut axis's transport.  Returns (x_body, x_seam);
    x_seam is None except on the last rank of a direction with a seam."""
    tracing.count(SCAN)
    axis = axis % rb.ndim
    s = rb.shape[axis]
    (dinv_b, dinv_s), (l_prev, l_b) = dinv, l
    seam = rs is not None and tr.rank == tr.size - 1
    r, piv, a_fwd, a_bwd = rb, dinv_b, torch.cat([l_prev, l_b.narrow(axis, 0, s - 1)], axis), l_b
    if seam:  # the seam face n closes the last rank's scan: its l_{n-1} is l_b's last
        r, piv = torch.cat([rb, rs], axis), torch.cat([dinv_b, dinv_s], axis)
        a_fwd = torch.cat([l_prev, l_b], axis)
        a_bwd = torch.cat([l_b, torch.zeros_like(l_prev)], axis)
    A, B = affine_pairs(-a_fwd, r, axis)
    z = A * _carry(A, B, axis, tr, first=False) + B
    A, B = affine_pairs(-a_bwd, z * piv, axis, reverse=True)
    x = A * _carry(A, B, axis, tr, first=True) + B
    if cyclic is not None:
        wt, a0, a1 = cyclic
        g = tr.all_gather(torch.stack([x.narrow(axis, 0, 1), x.narrow(axis, s - 1, 1)]))
        x = x - wt * (a0 * g[0, 0] + a1 * g[tr.size - 1, 1])
    if seam:
        return x.narrow(axis, 0, s), x.narrow(axis, s, 1)
    return x, None


def partitioned_face_solve(di, L, R, ctx: Dict, key: str, tr):
    """The cut direction's masked, m_t-scaled A-solve on a rank's faces
    (``solve_A_dir``'s semantics): the face rhs of face j is L_j + R_{j-1}
    (L, R: the left- and right-face contributions of the rank's cells, (...,
    T, s cells along the axis, ...); face 0 takes the previous rank's last R
    plane, one plane sent), the seam's is the last rank's last R.  The JAX
    rule picks the solve (``parallel.shard_context`` decided it when it
    sliced the context):

    * the ``tri_part_*`` bundle: the partitioned method;
    * an exact A with no bundle (a segment of one face, ``NEUTFEM_PARTTRI=0``;
      ``tri_l_{key}__prev`` present): the scan solve (``tridiag_solve_scan``);
    * a PERIODIC direction (its ``cyc_*`` slab): the tied face n folded into
      face 0 (rank 0 takes the last rank's last R: the shift wraps round the
      ring), the folded system of n faces by the scan solve with its
      Sherman-Morrison correction;
    * "diag" / "lumped" (no ``tri_l``): each face its own system, x = rhs *
      ``tri_dinv``, on the body faces and the seam alike.

    Returns the rank's s+1 faces' solution: its s body faces and the face
    that closes its slab (the next rank's first face, one plane sent, or the
    seam on the last rank; rank 0's first face on a PERIODIC direction)."""
    axis = (di.axis - 3) % L.ndim
    s = L.shape[axis]
    m_t = _const(di.m_t, L).reshape(-1, 1, 1, 1)
    cyc = cyc_args(ctx, key)
    mb = ctx[f"mask_{key}"]
    prev = tr.shift(R.narrow(axis, s - 1, 1), +1, cyc is not None)
    rb = (L + torch.cat([prev, R.narrow(axis, 0, s - 1)], dim=axis)) * mb / m_t
    dinv = ctx[f"tri_dinv_{key}"].unsqueeze(-4)
    lf = None  # the scan solve's couplings, where shard_context attached them
    if f"tri_l_{key}__prev" in ctx:
        lf = (ctx[f"tri_l_{key}__prev"].unsqueeze(-4), ctx[f"tri_l_{key}"].unsqueeze(-4))
    if cyc is not None:
        x, _ = tridiag_solve_scan(rb, None, (dinv, None), lf, axis, tr,
                                  tuple(t.unsqueeze(-4) for t in cyc))
        return seam_faces(x * mb, None, axis, tr, cyclic=True)
    ms = ctx[f"mask_{key}__seam"]
    rs = R.narrow(axis, s - 1, 1) * ms / m_t
    dinv_s = ctx[f"tri_dinv_{key}__seam"].unsqueeze(-4)
    if f"tri_part_dinv_{key}" in ctx:
        tracing.count(PARTTRI)
        part = {nm: ctx[f"tri_part_{nm}_{key}"] for nm in PART_NAMES}
        x, x_seam = tridiag_solve_partitioned(rb, rs, part, axis, tr)
    elif lf is not None:
        x, x_seam = tridiag_solve_scan(rb, rs, (dinv, dinv_s), lf, axis, tr)
    else:
        tracing.count(PARTTRI)
        x, x_seam = rb * dinv, rs * dinv_s
    return seam_faces(x * mb, None if x_seam is None else x_seam * ms, axis, tr)


def partitioned_schur_dir(fes, di, v, ctx: Dict, key: str, tr, BXt):
    """The whole cut-direction Schur contribution B_d A_d^{-1} B_d^T v of a
    rank's slab (the JAX ``partitioned_schur_dir``): face rhs, partitioned
    solve, divergence, with the semantics of the unfused chain (``_face_rhs``
    -> masked, m_t-scaled ``solve_A_dir`` -> mask -> ``_face_out``).  BXt is a
    host (2+, P, T) pairing tensor: ``di.BXc`` for the condensed chain,
    ``di.BX[:2]`` for RT0.  ``fes`` is unused (the JAX signature's)."""
    F = partitioned_face_solve(di, _pair(v, BXt[0]), _pair(v, BXt[1]), ctx, key, tr)
    return _face_out(di, F, BXt)
