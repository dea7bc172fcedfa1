"""Matrix-free applications of the RT0-P0 mixed-FEM operators on structured grids.

Port of ``neutfem_tpu/ops/apply.py`` for the RT0-P0 slice (no bubbles, no
PERIODIC direction, single device):

* ``apply_BT_dir`` / ``apply_B_dir``: the divergence pairing as scalar multiplies
  plus shifted neighbour sums,
* ``solve_A_dir``: the exact per-direction face-tridiagonal solve (``tridiag_solve``),
* ``schur_matvec``: S v = C v + sum_d B_d A_d^{-1} B_d^T v, either through the
  fused direction kernels (``ops/fused.py``, the main path) or as the unfused
  composition of the three ops above (a cross-check).

Axis convention (INTERNAL, mode-axis-first, as the JAX package):

* flux      ``(..., P, nz, ny, nx)``          — mode axis at position -4
* J face d  ``(..., T, *face_shape)``         — transverse-mode axis at -4
* spatial axes are ALWAYS the last three; direction d's axis is ``di.axis - 3``.

Public (caller-facing) arrays keep the reference-shaped trailing-mode layout
``(ng, nz, ny, nx, P)``; ``power.py`` converts at its boundary.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..fespace import DirectionInfo, FESpace
from .fused import fused_schur_x_pre, fused_schur_y_pre, fused_schur_z
from .tridiag import tridiag_solve

__all__ = [
    "apply_BT_dir",
    "apply_B_dir",
    "solve_A_dir",
    "schur_matvec",
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
    return {key: {"face": entry["face"].movedim(-4, -1).contiguous()}
            for key, entry in J.items()}


def _require_rt0(fes: FESpace):
    if fes.et.k != 0 or fes.m != 0:
        raise NotImplementedError("only RT0-P0 is ported")


def _pad_zero(arr, axis: int, front: bool):
    """Pad one zero slice along `axis` (negative axis ok)."""
    ax = axis % arr.ndim
    shape = list(arr.shape)
    shape[ax] = 1
    z = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    return torch.cat([z, arr] if front else [arr, z], dim=ax)


def apply_BT_dir(fes: FESpace, di: DirectionInfo, phi):
    """B_d^T phi: face rhs (..., T, n_d+1 along di) and the bubble rhs (None for RT0).

    The P = T = 1 contraction is a scalar multiply."""
    _require_rt0(fes)
    ax = di.axis - 3
    c0 = phi * float(di.BX[0, 0, 0])  # element's left-face row
    c1 = phi * float(di.BX[1, 0, 0])  # element's right-face row
    rF = _pad_zero(c0, ax, front=False) + _pad_zero(c1, ax, front=True)
    return rF, None


def apply_B_dir(fes: FESpace, di: DirectionInfo, F, W):
    """B_d J: flux-shaped (..., P, sp) contribution from direction d."""
    _require_rt0(fes)
    if W is not None:
        raise NotImplementedError("bubble DOFs (k > 0) are not ported")
    ax = di.axis - 3
    n = F.shape[ax]
    F_L = F.narrow(ax, 0, n - 1)  # per-element left face value
    F_R = F.narrow(ax, 1, n - 1)
    return F_L * float(di.BX[0, 0, 0]) + F_R * float(di.BX[1, 0, 0])


def solve_A_dir(fes: FESpace, di: DirectionInfo, dinv, l, mask, alpha, rF, rW,
                a_mode: str):
    """Exact solve of the per-direction RT mass block A_d J = r (face DOFs only).

    dinv, l : tridiagonal factors over faces (batch..., face_shape).
    mask    : (face_shape) 1.0 for free faces, 0.0 for pinned (MIRROR) ones.
    alpha   : (batch..., nz, ny, nx) element coefficient; only bubbles read it.
    Returns (F, None) in the internal layout."""
    _require_rt0(fes)
    if rW is not None:
        raise NotImplementedError("bubble DOFs (k > 0) are not ported")
    if a_mode != "exact":
        raise NotImplementedError(f"a_mode={a_mode!r}: only 'exact' is ported")
    ax = di.axis - 3
    m_t = torch.as_tensor(di.m_t, dtype=rF.dtype, device=rF.device).reshape(-1, 1, 1, 1)
    rF = rF * mask
    rFs = rF / m_t
    # factors have no T axis: align them against (..., T, face_shape)
    F = tridiag_solve(rFs, dinv.unsqueeze(-4), l.unsqueeze(-4), axis=ax % rFs.ndim)
    return F * mask, None


def schur_matvec(fes: FESpace, ctx: Dict, v, a_mode: str = "exact", fused: bool = True):
    """S v = C v + sum_d B_d A_d^{-1} B_d^T v   (matrix-free Schur complement).

    ``fused=True`` (the solver's path) runs one fused direction kernel per
    direction on one group's flux (``v`` and ``ctx`` group-sliced); each kernel
    updates the accumulator in place.  ``fused=False`` composes apply_BT_dir,
    solve_A_dir and apply_B_dir, and also takes all groups at once."""
    _require_rt0(fes)
    if a_mode != "exact":
        raise NotImplementedError(f"a_mode={a_mode!r}: only 'exact' is ported")
    out = ctx["C"] * v
    for di in fes.dirs:
        key = f"d{di.d}"
        if fused:
            bx0 = float(di.BX[0, 0, 0])
            bx1 = float(di.BX[1, 0, 0])
            si = 1.0 / float(di.m_t[0])
            if di.axis == 2:
                fused_schur_x_pre(out, v, ctx[f"tri_xT_dinvm_{key}"],
                                  ctx[f"tri_xT_l_{key}"], bx0, bx1, si)
            elif di.axis == 1:
                fused_schur_y_pre(out, v, ctx[f"tri_yT_dinvm_{key}"],
                                  ctx[f"tri_yT_l_{key}"], bx0, bx1, si)
            else:
                fused_schur_z(out, v, ctx[f"tri_dinvm_{key}"], ctx[f"tri_l_{key}"],
                              bx0, bx1, si)
            continue
        rF, _ = apply_BT_dir(fes, di, v)
        F, _ = solve_A_dir(fes, di, ctx[f"tri_dinv_{key}"], ctx[f"tri_l_{key}"],
                           ctx[f"mask_{key}"], ctx[f"alpha_{key}"], rF, None, a_mode)
        out = out + apply_B_dir(fes, di, F, None)
    return out


def weighted_mass(fes: FESpace, coeff, detJ, w_mode_col, phi):
    """(coeff-weighted mass) @ phi — diagonal in the tensor-Legendre basis.

    coeff: (..., nz, ny, nx) per-element coefficient (e.g. nu-Sigma_f);
    w_mode_col: (P, 1, 1, 1) per-mode mass weight; phi internal (..., P, sp)."""
    return (coeff * detJ).unsqueeze(-4) * (w_mode_col * phi)
