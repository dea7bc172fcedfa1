"""Build the operator context ("BuildMatrices" equivalent) as torch tensors.

Port of ``neutfem_tpu/ops/context.py`` for the RT0-P0 slice (``a_mode="exact"``,
no PERIODIC direction, no nonzero NEUMANN lift).  The "matrices" are a handful of
dense grids, built host-side in numpy (float64) and transferred once:

* ``C``              (ng, P, nz, ny, nx): removal term Sigma_r * detJ * w_mode
* ``alpha_d{d}``     (ng, nz, ny, nx): RT mass coefficient factor_d / D_g
* ``tri_dinv_d{d}``, ``tri_l_d{d}``: LDL^T factors of the face-tridiagonal A-blocks
  (per group, per direction), along the face axis
* ``mask_d{d}``      (face_shape): 0 at pinned (MIRROR / NEUMANN-0) faces
* ``tri_dinvm_d{d}`` dinv * mask, the fused direction kernels' operand, plus the
  solve-axis-major staged copies ``tri_yT_*`` (ny+1 / ny, nz, nx) and
  ``tri_xT_*`` (nx+1 / nx, nz*ny) that the y and x kernels read
* ``precond_inv``    (ng, P, nz, ny, nx): 1 / exact diag(S), the Jacobi
  equilibration of the Schur CG
* ``detJ``, ``w_mode_col``, ``nsf``, ``chi``, ``sigs``, ``src``: the power
  iteration's fission / scattering weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..bc import BCKind, BCSpec
from ..fespace import FESpace
from ..mesh import boundary_attribute
from ..native import tridiag_ldlt_batch

__all__ = ["build_context", "ctx_from_numpy"]


def _axslice(ndim: int, axis: int, s) -> tuple:
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def _tinv_dd_od(dinv_a, l_a, fax_a):
    """diag(T^-1) and (T^-1)_{i,i+1} from the LDL^T factors, O(n):
    (T^-1)_{nn} = d^-1_n;  (T^-1)_{ii} = d^-1_i + l_i^2 (T^-1)_{i+1,i+1};
    (T^-1)_{i,i+1} = -l_i (T^-1)_{i+1,i+1}."""
    di_m = np.moveaxis(dinv_a, fax_a, -1)
    lm = np.moveaxis(l_a, fax_a, -1)
    n1 = di_m.shape[-1]
    dd = np.empty_like(di_m)
    od = np.empty_like(lm)
    dd[..., n1 - 1] = di_m[..., n1 - 1]
    for i in range(n1 - 2, -1, -1):
        dd[..., i] = di_m[..., i] + lm[..., i] ** 2 * dd[..., i + 1]
        od[..., i] = -lm[..., i] * dd[..., i + 1]
    return np.moveaxis(dd, -1, fax_a), np.moveaxis(od, -1, fax_a)


def ctx_from_numpy(ctx_np: Dict[str, np.ndarray], device, dtype) -> Dict[str, torch.Tensor]:
    """Operator context given as numpy arrays (e.g. the JAX package's context,
    ``{k: np.asarray(v) for k, v in jax_ctx.items()}``) -> contiguous tensors
    (always copies, so no tensor shares memory with the caller's arrays)."""
    out = {}
    for k, v in ctx_np.items():
        if isinstance(v, dict):
            raise NotImplementedError(f"nested context entry {k!r} is not supported")
        out[k] = torch.tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
    return out


def build_context(
    fes: FESpace,
    ng: int,
    xs: Dict[str, np.ndarray],
    bcs: BCSpec,
    device,
    dtype,
    a_mode: str = "exact",
    marshak_d_factor: bool = False,
) -> Dict[str, torch.Tensor]:
    """Operator context of the RT0-P0 exact mixed discretization on ``device``."""
    mesh = fes.mesh
    et = fes.et
    if a_mode != "exact":
        raise NotImplementedError(f"a_mode={a_mode!r}: only 'exact' is ported")
    if et.k != 0 or fes.m != 0:
        raise NotImplementedError("only RT0-P0 is ported")

    detJ = mesh.det_jac()  # (nz, ny, nx)
    w_mode = fes.w_mode  # (P,)
    D = np.asarray(xs["D"], dtype=np.float64)
    SigR = np.asarray(xs["SigR"], dtype=np.float64)

    w_col = w_mode.reshape(1, -1, 1, 1, 1)
    C = SigR[:, None] * detJ[None, None] * w_col  # (ng, P, nz, ny, nx)
    K = et.K

    ctx_np: Dict[str, np.ndarray] = {"C": C}
    jacs = [mesh.h_grid(a) / 2.0 for a in range(3)]  # fake axes: h=2 -> jac=1

    for di in fes.dirs:
        d, ax = di.d, di.axis  # ax in (nz, ny, nx) order
        key = f"d{d}"
        factor = jacs[d] ** 2 / detJ  # (nz, ny, nx)
        alpha = factor[None] / D  # (ng, nz, ny, nx)

        fshape = (ng, *di.face_shape)
        fax = 1 + ax  # face axis within (ng, *face_shape)
        n_faces = di.face_shape[ax]

        diag = np.zeros(fshape)
        # element e contributes K00 to its left face (index e) and K11 to its right (e+1)
        diag[_axslice(4, fax, slice(0, n_faces - 1))] += alpha * K[0, 0]
        diag[_axslice(4, fax, slice(1, n_faces))] += alpha * K[1, 1]
        offd = alpha * K[0, 1]  # (ng, nz, ny, nx): coupling between faces e and e+1

        mask = np.ones(di.face_shape)
        tr_axes = [a for a in range(3) if a != d and mesh.active(a)]
        n_tr = len(tr_axes)
        fa = np.ones(mesh.shape)
        for a in tr_axes:
            fa = fa * mesh.h_grid(a)  # physical face area, broadcast over cells

        for upper in (False, True):
            attr = boundary_attribute(mesh.dim, d, upper)
            kind = bcs.kind(attr)
            f_idx = n_faces - 1 if upper else 0
            e_idx = -1 if upper else 0
            face_sl = _axslice(4, fax, f_idx)
            elem_sl = _axslice(4, fax, e_idx)
            fa_b = fa[_axslice(3, ax, e_idx)]

            if kind == BCKind.PERIODIC:
                raise NotImplementedError("PERIODIC boundaries are not ported")
            if kind in (BCKind.DIRICHLET, BCKind.ROBIN):
                if kind == BCKind.DIRICHLET:
                    # Marshak vacuum: per-mode base units, t-independent 2 * 2^{n_tr} / fa
                    c = 2.0 * np.ones((ng,) + fa_b.shape)
                    if marshak_d_factor:
                        c = c * D[elem_sl]  # reference bug-compat (NeutFEM.cpp:1350)
                else:
                    c = bcs.robin_beta / (bcs.robin_alpha * D[elem_sl])
                diag[face_sl] += c * (2.0**n_tr) / fa_b
            elif kind in (BCKind.MIRROR, BCKind.NEUMANN):
                if kind == BCKind.NEUMANN and bcs.value(attr) != 0.0:
                    raise NotImplementedError("nonzero NEUMANN currents are not ported")
                # Pin the face: the off-diagonal out of it is zeroed BEFORE the
                # factorization, so its l and dinv*mask are exactly 0 — the
                # fused kernels rely on it (their rhs scale is the scalar 1/m_t).
                mask[_axslice(3, ax, f_idx)] = 0.0
                diag[face_sl] = 1.0
                offd[_axslice(4, fax, -1 if upper else 0)] = 0.0
            # BCKind.NONE: natural => zero boundary flux, no term (reference default)

        dd = np.moveaxis(diag, fax, -1)  # (..., n_faces)
        bb = np.moveaxis(offd, fax, -1)  # (..., n_faces - 1)
        dinv_l, ll = tridiag_ldlt_batch(dd, bb)
        dinv = np.moveaxis(dinv_l, -1, fax)
        l = np.moveaxis(ll, -1, fax)

        ctx_np[f"alpha_{key}"] = alpha
        ctx_np[f"tri_dinv_{key}"] = dinv
        ctx_np[f"tri_l_{key}"] = l
        ctx_np[f"mask_{key}"] = mask
        dmm = dinv * mask[None]
        ctx_np[f"tri_dinvm_{key}"] = dmm
        if ax == 2:
            # x: solve-constant operands pre-transposed to (n_faces, nz*ny)
            ctx_np[f"tri_xT_dinvm_{key}"] = np.swapaxes(
                dmm.reshape(ng, -1, dmm.shape[-1]), -1, -2)
            ctx_np[f"tri_xT_l_{key}"] = np.swapaxes(
                l.reshape(ng, -1, l.shape[-1]), -1, -2)
        elif ax == 1:
            # y: solve-axis-major (ny+1, nz, nx)
            ctx_np[f"tri_yT_dinvm_{key}"] = np.moveaxis(dmm, 2, 1)
            ctx_np[f"tri_yT_l_{key}"] = np.moveaxis(l, 2, 1)

    # Exact Schur diagonal: the diag-A estimate underestimates diag(S) by up to
    # ~460x at higher orders; the per-cell quadratic form of the exact solve is
    # c^T T^-1 c / m_t with c = (BX[0], BX[1]) over the element's two faces.
    pre = C.copy()
    for di in fes.dirs:
        key = f"d{di.d}"
        ax = di.axis
        fax = 1 + ax
        ncell = mesh.shape[ax]
        imt = 1.0 / di.m_t
        mask_d = ctx_np[f"mask_{key}"]
        dd, od = _tinv_dd_od(ctx_np[f"tri_dinv_{key}"], ctx_np[f"tri_l_{key}"], fax)
        dd = dd * mask_d[None]
        mL = mask_d[_axslice(3, ax, slice(0, ncell))]
        mR = mask_d[_axslice(3, ax, slice(1, ncell + 1))]
        od = od * (mL * mR)[None]
        ddL = dd[_axslice(4, fax, slice(0, ncell))]
        ddR = dd[_axslice(4, fax, slice(1, ncell + 1))]
        chat = np.array(di.BX[:2], dtype=np.float64)
        c00 = np.einsum("pt,qt,t->pq", chat[0], chat[0], imt)
        c11 = np.einsum("pt,qt,t->pq", chat[1], chat[1], imt)
        c01 = np.einsum("pt,qt,t->pq", chat[0], chat[1], imt)
        pre += (np.diagonal(c00).reshape(1, -1, 1, 1, 1) * ddL[:, None]
                + np.diagonal(c11).reshape(1, -1, 1, 1, 1) * ddR[:, None]
                + 2.0 * np.diagonal(c01).reshape(1, -1, 1, 1, 1) * od[:, None])

    ctx_np["precond_inv"] = 1.0 / pre
    ctx_np["detJ"] = detJ
    ctx_np["w_mode_col"] = w_mode.reshape(-1, 1, 1, 1)  # internal mode-first broadcast
    ctx_np["nsf"] = np.asarray(xs["NSF"], dtype=np.float64)
    ctx_np["chi"] = np.asarray(xs["Chi"], dtype=np.float64)
    ctx_np["sigs"] = np.asarray(xs["SigS"], dtype=np.float64)
    ctx_np["src"] = np.asarray(xs["SRC"], dtype=np.float64)
    return ctx_from_numpy(ctx_np, device, dtype)
