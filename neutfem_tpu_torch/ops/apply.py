"""Matrix-free applications of the mixed-FEM operators on structured grids.

Port of ``neutfem_tpu/ops/apply.py`` (single device):

* ``apply_BT_dir`` / ``apply_B_dir``: the divergence pairing as (P x T) einsums
  (scalar multiplies at RT0-P0) plus shifted neighbour sums, with the bubble
  rows for k >= 1,
* ``solve_A_dir``: the exact per-direction solve: static condensation of the
  bubble DOFs onto the face-tridiagonal system (``tridiag_solve``), then the
  bubble back-substitution; on a PERIODIC direction the cyclic system folded
  onto its n distinct faces and solved by Sherman-Morrison on the same
  Thomas solve (``cyc_args``); under ``a_mode`` "diag" / "lumped" the
  elementwise A^-1 ~ 1/diag(A),
* ``schur_matvec``: S v = C v + sum_d B_d A_d^{-1} B_d^T v.  RT0-P0 goes through
  the fused direction kernels (``ops/fused.py``: K1-K3 on one group, the
  group-batched kernel (K5) on every group at once); k >= 1 through the
  condensed form (``DirectionInfo.BXc`` / ``Qbub``), on one group of a 3D mesh
  with m == k as one fused kernel per direction (``ops/fused_ho.py``, K6),
  otherwise (2D, m < k, or group-batched) as the unfused condensed chain, as
  the JAX package does for those configurations.  The kernels take a
  direction only under ``a_mode="exact"`` and where it is not PERIODIC (the
  JAX rule, decided per direction): the others run the unfused chain, whose
  Thomas solve is K4 (K4′ at its layout) on the card.  ``fused=False`` runs
  the unfused chains (a cross-check).
* ``equilibrated_schur_matvec``: the CG's equilibrated matvec sdi * S(sdi * y)
  with the scalings folded into the direction kernels (``ops/fused_eq.py``,
  K7), taken by ``power.group_solve`` under ``NEUTFEM_EQFOLD=1|2`` where
  ``eqfold_available`` allows it.

Under a sharding scope (``shardctx``: one rank's slab of a multi-device
solve, ``parallel.py``) ``schur_matvec`` runs a direction along a cut as the
partitioned solve of ``ops/parttri.py``, or its scan solve where the JAX
package takes its associative scan (a PERIODIC cut direction, a segment of
one face, ``NEUTFEM_PARTTRI=0``), under "diag" / "lumped" their elementwise
counterpart, on one group or on every group at once (the Jacobi sweep: the
bundle then carries the group axis), and every other
direction as above on the rank's complete local lines (the context's staged
operands are the slab's, so K1-K3, K5 and K1's batch run there); the
equilibration fold declines there, as in the JAX package.

Axis convention (INTERNAL, mode-axis-first, as the JAX package):

* flux      ``(..., P, nz, ny, nx)``          — mode axis at position -4
* J face d  ``(..., T, *face_shape)``         — transverse-mode axis at -4
* J bub  d  ``(..., nbub, T, nz, ny, nx)``    — bubble axis at -5, T at -4
* spatial axes are ALWAYS the last three; direction d's axis is ``di.axis - 3``.

Public (caller-facing) arrays keep the reference-shaped trailing-mode layout
``(ng, nz, ny, nx, P)``; ``power.py`` converts at its boundary.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .. import tracing
from ..fespace import DirectionInfo, FESpace
from ..shardctx import current_sharding
from .fused import (
    fused_schur_x_batched,
    fused_schur_x_pre,
    fused_schur_y_batched,
    fused_schur_y_pre,
    fused_schur_z,
    fused_schur_z_batched,
)
from .fused_eq import (
    fused_schur_x_eq,
    fused_schur_x_eq2,
    fused_schur_y_eq2,
    fused_schur_z_eq,
    fused_schur_z_eq2,
)
from .fused_ho import fused_ho_x, fused_ho_y, fused_ho_z, ho_tables
from .tridiag import tridiag_solve

__all__ = [
    "apply_BT_dir",
    "apply_B_dir",
    "solve_A_dir",
    "bubble_solve",
    "cyc_args",
    "dir_factors",
    "schur_matvec",
    "eqfold_available",
    "equilibrated_schur_matvec",
    "weighted_mass",
    "phi_to_internal",
    "phi_to_public",
    "J_to_public",
]


def phi_to_internal(phi):
    """Public (..., nz, ny, nx, P) -> internal (..., P, nz, ny, nx)."""
    return phi.movedim(-1, -4).contiguous()


def phi_to_public(phi):
    """Internal (..., P, nz, ny, nx) -> public (..., nz, ny, nx, P)."""
    return phi.movedim(-4, -1).contiguous()


def J_to_public(J: Dict) -> Dict:
    """Convert a current dict from internal to public (trailing-mode) layout."""
    out = {}
    for key, entry in J.items():
        pub = {"face": entry["face"].movedim(-4, -1).contiguous()}
        if "bub" in entry:
            pub["bub"] = entry["bub"].movedim((-5, -4), (-2, -1)).contiguous()
        out[key] = pub
    return out


def _pad_zero(arr, axis: int, front: bool):
    """Pad one zero slice along `axis` (negative axis ok)."""
    ax = axis % arr.ndim
    shape = list(arr.shape)
    shape[ax] = 1
    z = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    return torch.cat([z, arr] if front else [arr, z], dim=ax)


_CONSTS: dict = {}  # (values, dtype, device) -> tensor, on the card


def _const(a, like):
    """A host constant (numpy) as a tensor of ``like``'s dtype and device.  On
    the card it is made once per (values, dtype, device): a host-to-device
    copy would synchronize the stream, and may not run inside a captured CUDA
    graph (``krylov.CGGraph``)."""
    if like.device.type != "cuda":
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    a = np.ascontiguousarray(a)
    key = (a.shape, a.dtype.str, a.tobytes(), like.dtype, str(like.device))
    hit = _CONSTS.get(key)
    if hit is None:
        with tracing.sync("upload"):
            hit = _CONSTS[key] = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return hit


def _pair(phi, BXf):
    """(..., P, sp) flux x (P, T) pairing row -> (..., T, sp)."""
    if BXf.shape == (1, 1):  # P == T == 1 (RT0-P0): a scalar multiply, no einsum
        return phi * float(BXf[0, 0])
    return torch.einsum("...pzyx,pt->...tzyx", phi, _const(BXf, phi))


def _unpair(F, BXf):
    """(..., T, sp) face values x (P, T) pairing row -> (..., P, sp)."""
    if BXf.shape == (1, 1):
        return F * float(BXf[0, 0])
    return torch.einsum("...tzyx,pt->...pzyx", F, _const(BXf, F))


def apply_BT_dir(fes: FESpace, di: DirectionInfo, phi):
    """B_d^T phi: face rhs (..., T, n_d+1 along di) and the bubble rhs
    (..., nbub, T, sp), None for RT0."""
    ax = di.axis - 3
    c0 = _pair(phi, di.BX[0])  # element's left-face row
    c1 = _pair(phi, di.BX[1])  # element's right-face row
    rF = _pad_zero(c0, ax, front=False) + _pad_zero(c1, ax, front=True)
    rW = None
    if fes.et.nbub > 0:
        rW = torch.einsum("...pzyx,lpt->...ltzyx", phi, _const(di.BX[2:], phi))
    return rF, rW


def _face_rhs(di: DirectionInfo, phi, BXt):
    """Face rhs (..., T, faces) from flux with a (2, P, T) pairing tensor (BXc
    for the condensed matvec), as first / shifted sum / last slices."""
    ax = (di.axis - 3) % phi.ndim
    c0 = _pair(phi, BXt[0])
    c1 = _pair(phi, BXt[1])
    n = c0.shape[ax]
    return torch.cat([c0.narrow(ax, 0, 1),
                      c0.narrow(ax, 1, n - 1) + c1.narrow(ax, 0, n - 1),
                      c1.narrow(ax, n - 1, 1)], dim=ax)


def _face_out(di: DirectionInfo, F, BXt):
    """Flux-shaped contribution of face values F with pairing tensor BXt."""
    ax = di.axis - 3
    n = F.shape[ax]
    return _unpair(F.narrow(ax, 0, n - 1), BXt[0]) + _unpair(F.narrow(ax, 1, n - 1), BXt[1])


def apply_B_dir(fes: FESpace, di: DirectionInfo, F, W):
    """B_d J: flux-shaped (..., P, sp) contribution from direction d."""
    out = _face_out(di, F, di.BX)
    if W is not None:
        out = out + torch.einsum("...ltzyx,lpt->...pzyx", W, _const(di.BX[2:], W))
    return out


def solve_A_dir(fes: FESpace, di: DirectionInfo, dinv, l, mask, alpha, rF, rW,
                a_mode: str, cyc=None, aligned: bool = False):
    """Solve of the per-direction RT mass block A_d J = r.

    dinv, l : tridiagonal factors over faces (batch..., face_shape); l is None
              unless a_mode == "exact".  ``aligned``: they already carry the
              transverse-mode axis (the context's ``tri_cycT_*``, ``dir_factors``).
    mask    : (face_shape) 1.0 for free faces, 0.0 for pinned (MIRROR) ones.
    alpha   : (batch..., nz, ny, nx) element coefficient factor_d / D.
    rW      : bubble rhs (..., nbub, T, sp) for k >= 1, else None.
    cyc     : (wt, a0, a1) of a PERIODIC direction (``cyc_args``): the face
              grid has n+1 entries with face n tied to face 0; the n distinct
              faces form a cyclic system solved as y = T~^-1 rc, then
              x = y - wt (a0 y_0 + a1 y_{n-1}) (``ops/context.py``).
    Returns (F, W) face and bubble solutions in the internal layout (W None
    without bubbles)."""
    et = fes.et
    ax = di.axis - 3
    m_t = _const(di.m_t, rF).reshape(-1, 1, 1, 1)
    if rW is not None:
        # condense the bubbles onto the faces: rF -= G^T rW per element face
        corr = torch.einsum("fb,...btzyx->...ftzyx", _const(et.G.T, rW), rW)
        rF = (rF - _pad_zero(corr.select(-5, 0), ax, front=False)
              - _pad_zero(corr.select(-5, 1), ax, front=True))
    rF = rF * mask
    rFs = rF / m_t
    # factors have no T axis (unless aligned): align them against (..., T, face_shape)
    dinv_e = dinv if aligned else dinv.unsqueeze(-4)
    l_e = l if aligned or l is None else l.unsqueeze(-4)
    axn = ax % rFs.ndim
    if cyc is not None:
        # fold the tied face n into face 0, solve the cyclic system by
        # Sherman-Morrison, then re-expand (F[n] = F[0]); torch.cat makes the
        # folded rhs contiguous, as the Thomas kernel takes it
        wt, a0, a1 = (t.unsqueeze(-4) for t in cyc)
        n1 = rFs.shape[axn]
        rc = torch.cat([rFs.narrow(axn, 0, 1) + rFs.narrow(axn, n1 - 1, 1),
                        rFs.narrow(axn, 1, n1 - 2)], dim=axn)
        y = tridiag_solve(rc, dinv_e, l_e, axis=axn)
        s = a0 * y.narrow(axn, 0, 1) + a1 * y.narrow(axn, n1 - 2, 1)
        x = y - wt * s
        F = torch.cat([x, x.narrow(axn, 0, 1)], dim=axn)
    elif a_mode != "exact":
        F = rFs * dinv_e
    else:
        F = tridiag_solve(rFs, dinv_e, l_e, axis=axn)
    F = F * mask
    W = None if rW is None else bubble_solve(fes, di, F, rW, alpha)
    return F, W


def bubble_solve(fes: FESpace, di: DirectionInfo, F, rW, alpha):
    """``solve_A_dir``'s bubble back-substitution: the bubble solution (...,
    nbub, T, sp) from the face solution F (n+1 faces along the direction),
    the bubble rhs rW and alpha: W = Mbb^-1 rW / (alpha m_t) - G F_loc, with
    F_loc each cell's two faces."""
    et = fes.et
    ax = di.axis - 3
    m_t = _const(di.m_t, rW).reshape(-1, 1, 1, 1)
    n = F.shape[ax]
    F_loc = torch.stack([F.narrow(ax, 0, n - 1), F.narrow(ax, 1, n - 1)], dim=-5)
    alpha_e = alpha.unsqueeze(-4).unsqueeze(-5)
    W = torch.einsum("bc,...ctzyx->...btzyx", _const(et.Mbb_inv, rW), rW) / (alpha_e * m_t)
    return W - torch.einsum("bf,...ftzyx->...btzyx", _const(et.G, F_loc), F_loc)


def cyc_args(ctx: Dict, key: str):
    """The Sherman-Morrison bundle (wt, a0, a1) of a periodic direction, or None."""
    wt = ctx.get(f"cyc_wt_{key}")
    if wt is None:
        return None
    return (wt, ctx[f"cyc_a0_{key}"], ctx[f"cyc_a1_{key}"])


def dir_factors(ctx: Dict, key: str):
    """The keywords of ``solve_A_dir`` for direction ``key`` of ``ctx``: the
    factors (``tri_l`` None under "diag" / "lumped"), the periodic bundle, and
    the factors broadcast over the transverse modes where the context staged
    them (a periodic direction with T > 1), so the solve copies none."""
    staged = f"tri_cycT_dinv_{key}" in ctx
    pre = "tri_cycT" if staged else "tri"
    return {"dinv": ctx[f"{pre}_dinv_{key}"], "l": ctx.get(f"{pre}_l_{key}"),
            "mask": ctx[f"mask_{key}"], "alpha": ctx[f"alpha_{key}"],
            "cyc": cyc_args(ctx, key), "aligned": staged}


def _bubble_block(fes: FESpace, di: DirectionInfo, v, ctx: Dict, key: str):
    """The condensed chain's per-cell P x P term of direction ``di``,
    Qbub v / alpha (``fespace.DirectionInfo``)."""
    alpha_e = ctx[f"alpha_{key}"].unsqueeze(-4)
    if fes.P == 1:
        return v * (float(di.Qbub[0, 0]) / alpha_e)
    return torch.einsum("...qzyx,pq->...pzyx", v, _const(di.Qbub, v)) / alpha_e


def schur_matvec(fes: FESpace, ctx: Dict, v, a_mode: str = "exact", fused: bool = True):
    """S v = C v + sum_d B_d A_d^{-1} B_d^T v   (matrix-free Schur complement).

    ``fused=True`` (the solver's path) runs one fused direction kernel per
    direction where the configuration has one: on one group's flux (``v`` and
    ``ctx`` group-sliced) RT0-P0 runs K1-K3 and 3D RT_k-P_k K6; on every
    group at once (``ctx`` not sliced, ``v`` (ng, P, nz, ny, nx): the Jacobi
    group sweep) RT0-P0 runs the group-batched kernel and k >= 1 the unfused
    condensed chain, where the JAX package's K6 wrapper declines too.  Each
    kernel updates the accumulator in place.  A direction takes its kernel
    only under ``a_mode="exact"`` and where it is not periodic (the JAX
    rule, per direction); the others run the unfused chain.  ``fused=False``
    runs the unfused chains, and also takes all groups at once."""
    out = ctx["C"] * v
    condensed = fes.et.nbub > 0
    batched = ctx["C"].ndim == 5  # (ng, P, nz, ny, nx): the context is not group-sliced
    sh = current_sharding()
    cut = {}  # direction key -> the transport of its cut axis (a sharding scope)
    if sh is not None:
        mesh, amap = sh
        cut = {f"d{di.d}": mesh.axes[amap[di.axis]] for di in fes.dirs if di.axis in amap}
    # the JAX package's static rule for K6: a 3D mesh and m == k (the flux
    # modes factor as K1^3), one group; other k >= 1 configurations run the
    # unfused chain
    ho_kernel = (fused and condensed and not batched and fes.mesh.dim == 3
                 and fes.m == fes.k)
    for di in fes.dirs:
        key = f"d{di.d}"
        if key in cut:
            # the direction along a cut: the partitioned or the scan solve of
            # this rank's segment (ops/parttri.py); every other direction runs below on
            # the rank's complete local lines, with the kernel operands
            # parallel.shard_context restaged from its slab
            from .parttri import partitioned_schur_dir

            out = out + partitioned_schur_dir(fes, di, v, ctx, key, cut[key],
                                              di.BXc if condensed else di.BX[:2])
            if condensed:
                out = out + _bubble_block(fes, di, v, ctx, key)
            continue
        kernel = fused and a_mode == "exact" and f"cyc_wt_{key}" not in ctx
        if condensed:
            if ho_kernel and kernel:
                tabs = ho_tables(fes, di)
                if di.axis == 2:
                    fused_ho_x(out, v, ctx[f"tri_hoxT_dinvm_{key}"], ctx[f"tri_hoxT_l_{key}"],
                               ctx[f"tri_hoxT_alpha_{key}"], tabs)
                elif di.axis == 1:
                    fused_ho_y(out, v, ctx[f"tri_hoyT_dinvm_{key}"], ctx[f"tri_hoyT_l_{key}"],
                               ctx[f"tri_hoyT_alpha_{key}"], tabs)
                else:
                    fused_ho_z(out, v, ctx[f"tri_dinvm_{key}"], ctx[f"tri_l_{key}"],
                               ctx[f"alpha_{key}"], tabs)
                continue
            # the bubble algebra folded into BXc (face pairing) and Qbub
            # (per-cell block), fespace.DirectionInfo
            rF = _face_rhs(di, v, di.BXc)
            F, _ = solve_A_dir(fes, di, rF=rF, rW=None, a_mode=a_mode, **dir_factors(ctx, key))
            out = out + _face_out(di, F, di.BXc) + _bubble_block(fes, di, v, ctx, key)
            continue
        if kernel:
            bx0 = float(di.BX[0, 0, 0])
            bx1 = float(di.BX[1, 0, 0])
            si = 1.0 / float(di.m_t[0])
            x_fn, y_fn, z_fn = ((fused_schur_x_batched, fused_schur_y_batched,
                                 fused_schur_z_batched) if batched else
                                (fused_schur_x_pre, fused_schur_y_pre, fused_schur_z))
            if di.axis == 2:
                x_fn(out, v, ctx[f"tri_xT_dinvm_{key}"], ctx[f"tri_xT_l_{key}"], bx0, bx1, si)
            elif di.axis == 1:
                y_fn(out, v, ctx[f"tri_yT_dinvm_{key}"], ctx[f"tri_yT_l_{key}"], bx0, bx1, si)
            else:
                z_fn(out, v, ctx[f"tri_dinvm_{key}"], ctx[f"tri_l_{key}"], bx0, bx1, si)
            continue
        rF, _ = apply_BT_dir(fes, di, v)
        F, _ = solve_A_dir(fes, di, rF=rF, rW=None, a_mode=a_mode, **dir_factors(ctx, key))
        out = out + apply_B_dir(fes, di, F, None)
    return out


def eqfold_available(fes: FESpace, ctx: Dict, shape, dtype, a_mode: str) -> bool:
    """True iff ``equilibrated_schur_matvec`` serves a CG on fluxes of this
    shape and dtype: the JAX package's semantic gates
    (``neutfem_tpu/ops/apply.py:491-532``) — ``NEUTFEM_EQFOLD`` "1" or "2",
    exact A, RT0-P0 in 3D, the eq operands (``build_context`` stages them
    under the same switch) and the staged x/y operands in the context, no
    periodic direction, and one group's flux (every leading dim 1: the Jacobi
    sweep's batched flux keeps the classic matvec).  The TPU tile and VMEM
    gates are not ported (as for K1-K3), so the port also folds at sizes
    where the JAX package declines, such as IAEA-3D 1x1: the same operator,
    up to the association of the scalings."""
    if os.environ.get("NEUTFEM_EQFOLD", "0") not in ("1", "2"):
        return False
    if current_sharding() is not None:
        return False  # the JAX rule (neutfem_tpu/ops/apply.py:521-523)
    if a_mode != "exact" or fes.et.k != 0 or fes.m != 0 or len(fes.dirs) != 3:
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    needed = ("precond_eq_sdi", "precond_eq_csdi", "tri_xT_dinvm_d0", "tri_yT_dinvm_d1",
              "tri_dinvm_d2")
    if any(k not in ctx for k in needed) or any(f"cyc_wt_d{di.d}" in ctx for di in fes.dirs):
        return False
    return len(shape) >= 3 and all(s == 1 for s in shape[:-3])


def equilibrated_schur_matvec(fes: FESpace, ctx: Dict, y, a_mode: str = "exact"):
    """sdi * S(sdi * y) with sdi = ``precond_eq_sdi`` (diag(S)^-1/2), folded into
    the three direction kernels (``neutfem_tpu/ops/apply.py:535-613``):

    * ``NEUTFEM_EQFOLD=1``: the x kernel forms u = sdi*y, writes it out and
      adds the C*sdi*y term (``precond_eq_csdi`` = C*sdi); the y direction is
      K2 on u; the z kernel applies the final sdi;
    * ``"2"`` (and any other value, as the JAX package's default): every
      kernel recomputes u = sdi*y from y and sdi, u is never stored.

    ``ctx`` is one group's context and ``y`` one group's flux; the caller
    checked ``eqfold_available`` (which declines any ``a_mode`` but "exact")."""
    dis = {di.d: di for di in fes.dirs}

    def coef(d):  # (bx0, bx1, si) of direction d
        di = dis[d]
        return float(di.BX[0, 0, 0]), float(di.BX[1, 0, 0]), 1.0 / float(di.m_t[0])

    sdi, ce = ctx["precond_eq_sdi"], ctx["precond_eq_csdi"]
    xT = (ctx["tri_xT_dinvm_d0"], ctx["tri_xT_l_d0"])
    yT = (ctx["tri_yT_dinvm_d1"], ctx["tri_yT_l_d1"])
    z = (ctx["tri_dinvm_d2"], ctx["tri_l_d2"])
    if os.environ.get("NEUTFEM_EQFOLD", "2") == "1":
        acc, u = fused_schur_x_eq(y, sdi, ce, *xT, *coef(0))
        fused_schur_y_pre(acc, u, *yT, *coef(1))
        return fused_schur_z_eq(acc, u, *z, sdi, *coef(2))
    acc = fused_schur_x_eq2(y, sdi, ce, *xT, *coef(0))
    fused_schur_y_eq2(acc, y, sdi, *yT, *coef(1))
    return fused_schur_z_eq2(acc, y, sdi, *z, *coef(2))


def weighted_mass(fes: FESpace, coeff, detJ, w_mode_col, phi):
    """(coeff-weighted mass) @ phi — diagonal in the tensor-Legendre basis.

    coeff: (..., nz, ny, nx) per-element coefficient (e.g. nu-Sigma_f);
    w_mode_col: (P, 1, 1, 1) per-mode mass weight; phi internal (..., P, sp)."""
    return (coeff * detJ).unsqueeze(-4) * (w_mode_col * phi)
