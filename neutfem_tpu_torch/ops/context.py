"""Build the operator context ("BuildMatrices" equivalent) as torch tensors.

Port of ``neutfem_tpu/ops/context.py``: ``a_mode`` "exact" at any order
RT_k-P_m, "diag" and "lumped" at RT0; PERIODIC directions and nonzero NEUMANN
boundaries.  The "matrices" are a handful of dense grids, built host-side in
numpy (float64) and transferred once (but the block-Jacobi inverse, which the
device builds from host ingredients):

* ``C``              (ng, P, nz, ny, nx): removal term Sigma_r * detJ * w_mode
* ``alpha_d{d}``     (ng, nz, ny, nx): RT mass coefficient factor_d / D_g
* ``tri_dinv_d{d}``, ``tri_l_d{d}``: LDL^T factors of the (bubble-condensed)
  face-tridiagonal A-blocks (per group, per direction), along the face axis;
  under ``a_mode`` "diag" / "lumped" (RT0 only) ``tri_dinv`` = 1 / diag(A)
  (for "lumped", A lumped by row sums, ``diag(M1_lumped)``) and no ``tri_l``
* ``mask_d{d}``      (face_shape): 0 at pinned (MIRROR / NEUMANN) faces
* a PERIODIC direction (both ends PERIODIC): face n is tied to face 0, and the
  n distinct faces form a cyclic tridiagonal system whose corner coupling c
  is split off as a rank-1 update (Sherman-Morrison): ``tri_dinv`` /
  ``tri_l`` factor T~ (n / n-1 entries along the axis), ``cyc_wt_d{d}`` =
  T~^-1 w, ``cyc_a0_d{d}`` / ``cyc_a1_d{d}`` the correction's weights
  (keepdims face planes), ``mask`` all ones, and no fused-kernel operands (the
  matvec runs the unfused chain there, as the JAX package does); with T > 1
  transverse modes the factors are also broadcast over T once,
  ``tri_cycT_dinv_d{d}`` / ``tri_cycT_l_d{d}`` (ng, T, ...), so a solve
  copies none of them
* a nonzero NEUMANN value q (an inward current density): the lift
  J = J' + J_q, ``jcorr_d{d}`` (ng, face_shape) added to the output current
  and ``src_bc`` (ng, P, nz, ny, nx) added to every fixed-source group rhs
* ``tri_dinvm_d{d}`` dinv * mask, the fused direction kernels' operand, plus the
  solve-axis-major staged copies the y and x kernels read: for RT0-P0
  ``tri_yT_*`` (ny+1 / ny, nz, nx) and ``tri_xT_*`` (nx+1 / nx, nz*ny); for
  k >= 1 ``tri_hoyT_{dinvm,l,alpha}`` (same y layout) and
  ``tri_hoxT_{dinvm,l,alpha}`` (same x layout; the JAX package pads ny up to a
  128-lane tile there, which the port does not)
* ``precond_inv``    (ng, P, nz, ny, nx): 1 / exact diag(S), the Jacobi
  equilibration of the Schur CG (with the bubble-condensation terms for k >= 1;
  a periodic direction keeps its diag-A estimate); under "diag" / "lumped"
  1 / the diag-A estimate S_ee = C_ee + sum_f B_ef^2 / A_ff
* for P == 1 the line preconditioner's LDL^T factors, along the highest active
  direction (``precond_line_dinv`` / ``precond_line_l``: z in 3D, y in 2D) and
  the next one (``precond_line2_*``), (ng, nz, ny, nx) with one entry fewer
  along the line in ``_l``
* for P > 1 the P x P block-Jacobi inverse of the equilibrated Schur diagonal
  block, (ng, P, P, nz, ny, nx), the one part built on the device (in
  float64, from the host's cell-plane ingredients): ``precond_blk_inv`` at
  float64; at float32 the deviation ``precond_blk_dev = Binv - I`` in
  ``float8_e4m3fn`` when max|E| < 440, else ``precond_blk_inv`` in
  ``bfloat16`` (the JAX package's storage rule); with ``NEUTFEM_BLKFP8=0``
  float32 stores the ``bfloat16`` inverse
* under ``NEUTFEM_EQFOLD`` "1" or "2" at RT0-P0, the operands of the
  equilibration-folded matvec (``ops/fused_eq.py``): ``precond_eq_sdi`` =
  1/sqrt(diag S) and ``precond_eq_csdi`` = C * precond_eq_sdi, (ng, 1, nz,
  ny, nx)
* ``detJ``, ``w_mode`` (P,) and ``w_mode_col`` (P, 1, 1, 1), ``nsf``, ``chi``,
  ``sigs``, ``src``: the power iteration's fission / scattering weights;
* the CMFD coupling data (``cmfd.py``, NeutFEM.cpp:714-809): ``dtilde_d{d}``
  (ng, face_shape), interior ``2 D_L D_R / (D_L h_R + D_R h_L)`` and boundary
  ``2D/h`` (a periodic direction wraps the interior formula around the
  seam); ``area_d{d}`` (nz, ny, nx) the physical face area per cell;
  ``jscale_d{d}`` (face_shape) the physical current per unit face DOF,
  jac_d / detJ; ``sigr`` (ng, nz, ny, nx) the raw removal cross section and
  ``vol`` (nz, ny, nx) the cell volumes.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict

import numpy as np
import torch

from .. import tracing
from ..bc import BCKind, BCSpec
from ..fespace import FESpace
from ..mesh import boundary_attribute
from ..native import tridiag_ldlt_batch

__all__ = ["build_context", "build_host_context", "context_to_device", "ctx_from_numpy",
           "stage_operands"]


def _axslice(ndim: int, axis: int, s) -> tuple:
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def _tri_solve_np(dinv: np.ndarray, l: np.ndarray, b: np.ndarray, axis: int):
    """Host-side Thomas solve with precomputed LDL^T factors (build time only)."""
    d = np.moveaxis(dinv, axis, -1)
    ll = np.moveaxis(l, axis, -1)
    r = np.moveaxis(b, axis, -1).copy()
    n = r.shape[-1]
    for i in range(1, n):
        r[..., i] -= ll[..., i - 1] * r[..., i - 1]
    r[..., n - 1] = r[..., n - 1] * d[..., n - 1]
    for i in range(n - 2, -1, -1):
        r[..., i] = r[..., i] * d[..., i] - ll[..., i] * r[..., i + 1]
    return np.moveaxis(r, -1, axis)


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


def _line_factors(pre1: np.ndarray, offd: np.ndarray, fax: int):
    """LDL^T factors of the line-tridiagonal part of the Schur complement along
    one direction, on the symmetrically Jacobi-equilibrated system
    D^-1/2 M D^-1/2 (unit diagonal, O(1) off-diagonals: float32-safe with the
    1e15 void absorbers).  pre1 (ng, nz, ny, nx) is the exact diag(S) of P == 1;
    offd the interior off-diagonals along axis ``fax``."""
    pre_lo = pre1[_axslice(4, fax, slice(None, -1))]
    pre_hi = pre1[_axslice(4, fax, slice(1, None))]
    offd_hat = offd / np.sqrt(pre_lo * pre_hi)
    dinv_l, ll = tridiag_ldlt_batch(np.moveaxis(np.ones_like(pre1), fax, -1),
                                    np.moveaxis(offd_hat, fax, -1))
    return np.moveaxis(dinv_l, -1, fax), np.moveaxis(ll, -1, fax)


#: Low-precision numpy dtypes (ml_dtypes names) -> (same-width integer view, torch dtype).
_LOW_PRECISION = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                  "bfloat16": (np.int16, torch.bfloat16)}


def _unpack_lanes(a: np.ndarray, nz: int, ny: int) -> np.ndarray:
    """(..., rows, nz*wy) lane-packed x operand (ny padded to wy) -> (..., rows, nz*ny)."""
    wy = a.shape[-1] // nz
    return a.reshape(*a.shape[:-1], nz, wy)[..., :ny].reshape(*a.shape[:-1], nz * ny)


def ctx_from_numpy(ctx_np: Dict, device, dtype) -> Dict:
    """Operator context given as numpy arrays (e.g. the JAX package's context,
    ``{k: np.asarray(v) for k, v in jax_ctx.items()}``) -> contiguous tensors
    (always copies, so no tensor shares memory with the caller's arrays).

    Floating entries become ``dtype``, except the low-precision entries (the
    block preconditioner in ``float8_e4m3fn`` / ``bfloat16``, the two-grid
    level's ``bfloat16`` coarse inverse), which keep their dtype bit for bit.
    Nested dicts (the two-grid level ``"tg"``) are converted recursively.  The
    JAX package's lane-packed ``tri_hoxT_*`` x operands are re-staged into the
    port's (rows, nz*ny) layout by dropping the dead lanes."""
    out = {}
    for k, v in ctx_np.items():
        if isinstance(v, dict):  # a nested sub-context, e.g. the coarse level "tg"
            out[k] = ctx_from_numpy(v, device, dtype)
            continue
        v = np.asarray(v)
        if k.startswith("tri_hoxT_"):
            alpha = ctx_np[f"alpha_{k.rsplit('_', 1)[1]}"]  # (ng, nz, ny, nx)
            nz, ny = alpha.shape[-3], alpha.shape[-2]
            if v.shape[-1] != nz * ny:
                v = _unpack_lanes(v, nz, ny)
        low = _LOW_PRECISION.get(v.dtype.name)
        if low is not None:
            bits = torch.from_numpy(np.ascontiguousarray(v).view(low[0]).copy())
            out[k] = bits.view(low[1]).to(device)
            continue
        out[k] = torch.tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
    return out


#: Cells a chunk of the block build: bounds its float64 temporaries (blocks,
#: their equilibrated copy, the inverse and its workspace) to ~190 MB each at
#: P = 27, whatever the mesh.
BLOCK_CHUNK = 1 << 15


def _block_precond(blk: Dict[str, np.ndarray], P: int, device, dtype,
                   world=None) -> Dict[str, torch.Tensor]:
    """The equilibrated P x P block-Jacobi inverse, built on ``device`` from
    ``build_host_context``'s ingredients ``blk``, and stored by the JAX
    package's rule (``neutfem_tpu/ops/context.py:580-600``).

    One group at a time, a chunk of cells at a time, in float64: the blocks
    are the (P*P, J) coefficients times the J cell fields plus C on the
    diagonal, equilibrated by the exact Schur diagonal (unit diagonal:
    float32-safe) and inverted batched (LU with partial pivoting,
    ``torch.linalg.inv_ex``).  At float32 the inverse is rounded to float32
    and E = Binv - I taken in float32; under the default ``NEUTFEM_BLKFP8=1``
    the context stores E in float8 e4m3 (the identity part is applied
    exactly) when max|E| is below 440 (clear of e4m3's 448 saturation); with
    ``NEUTFEM_BLKFP8=0``, or near saturation, the float32 inverse in
    bfloat16.  Both are written chunk by chunk and one is kept.  Any other
    dtype keeps the inverse as it is.  ``world`` (a ``shardctx.Transport``):
    the ranks whose slabs make up the whole context, over which max|E| is
    reduced, so the storage decision is the whole context's.  The host read
    of that decision (with a count of singular blocks, which raise) waits for
    the device, inside the span ``neutfem.context.blockjac``;
    ``context.blockjac_blocks`` counts the blocks inverted."""
    f64, f32 = torch.float64, torch.float32
    with tracing.span("neutfem.context.blockjac"):
        fields = blk["fields"]  # (ng, J, nz, ny, nx)
        ng, J, shape = fields.shape[0], fields.shape[1], fields.shape[2:]
        n = int(np.prod(shape))
        low = dtype == f32
        store = {"precond_blk_inv": torch.empty((ng, P, P, n), device=device,
                                                dtype=torch.bfloat16 if low else dtype)}
        if low and os.environ.get("NEUTFEM_BLKFP8", "1") != "0":
            store["precond_blk_dev"] = torch.empty((ng, P, P, n), dtype=torch.float8_e4m3fn,
                                                   device=device)
        coefs = torch.as_tensor(blk["coefs"], dtype=f64, device=device)  # (P*P, J)
        emax = torch.zeros((), dtype=f32, device=device)
        singular = torch.zeros((), dtype=torch.int64, device=device)
        for g in range(ng):
            fg = torch.as_tensor(fields[g].reshape(J, n), dtype=f64, device=device)
            cg = torch.as_tensor(blk["C"][g].reshape(P, n), dtype=f64, device=device)
            sdi = 1.0 / torch.sqrt(torch.as_tensor(blk["pre"][g].reshape(P, n), dtype=f64,
                                                   device=device))  # (P, cells)
            for lo in range(0, n, BLOCK_CHUNK):
                hi = min(lo + BLOCK_CHUNK, n)
                b = (coefs @ fg[:, lo:hi]).reshape(P, P, hi - lo)
                b.diagonal(dim1=0, dim2=1).add_(cg[:, lo:hi].T)
                s = sdi[:, lo:hi]
                bh = (b * s[:, None] * s[None, :]).permute(2, 0, 1)  # (cells, P, P)
                inv, info = torch.linalg.inv_ex(bh)
                singular += torch.count_nonzero(info)
                e = inv.to(f32)
                store["precond_blk_inv"][g, :, :, lo:hi] = (e if low else inv).permute(1, 2, 0)
                e.diagonal(dim1=1, dim2=2).sub_(1.0)
                if "precond_blk_dev" in store:
                    store["precond_blk_dev"][g, :, :, lo:hi] = e.permute(1, 2, 0)
                emax = torch.maximum(emax, e.abs_().amax())
            tracing.count("context.blockjac_blocks", n)
        if world is not None:
            emax = world.all_max(emax)
        emax, singular = float(emax), int(singular)  # waits for the device
        if singular:
            raise torch.linalg.LinAlgError(f"block-Jacobi: {singular} singular P x P blocks")
        fp8 = "precond_blk_dev" in store and emax < 440.0
        keep = "precond_blk_dev" if fp8 else "precond_blk_inv"
        return {keep: store[keep].reshape((ng, P, P) + tuple(shape))}


def _dtilde_wrap(D, h_d, fax, ax):
    """CMFD Dtilde of a PERIODIC direction: the interior formula at every
    distinct face, the seam (face 0, whose left neighbour is the last cell)
    included; face n repeats face 0.  (ng, face_shape)."""
    D_l = np.roll(D, 1, axis=fax)
    h_l = np.roll(h_d, 1, axis=ax)
    dt = 2.0 * D_l * D / (D_l * h_d[None] + D * h_l[None])
    return np.concatenate([dt, dt[_axslice(4, fax, slice(0, 1))]], axis=fax)


def _cyclic_factors(alpha, K, fax: int):
    """The cyclic A-block of a PERIODIC direction over its n distinct faces
    (face i joins cells i-1 and i, cell n-1 closes the ring onto face 0),
    with the corner coupling c split off (``neutfem_tpu/ops/context.py:
    127-173``): A_cyc = T~ + w w^T / gamma, w = (gamma, 0, ..., 0, c), gamma =
    -(|c| + 1e-300), T~ = A_cyc with d_0 -= gamma and d_{n-1} -= c^2 / gamma.
    Returns (diag of T~, LDL^T factors of T~, wt = T~^-1 w, a0, a1): the
    solve is x = y - wt (a0 y_0 + a1 y_{n-1}) with y = T~^-1 b."""
    n = alpha.shape[fax]
    diag_c = alpha * K[0, 0] + np.roll(alpha, 1, axis=fax) * K[1, 1]
    offd_full = alpha * K[0, 1]  # entry i couples faces i and (i + 1) % n
    c = offd_full[_axslice(4, fax, slice(n - 1, n))]  # the corner, keepdims
    gamma = -(np.abs(c) + 1e-300)
    diag_c[_axslice(4, fax, slice(0, 1))] -= gamma
    diag_c[_axslice(4, fax, slice(n - 1, n))] -= c * c / gamma
    dinv_l, ll = tridiag_ldlt_batch(np.moveaxis(diag_c, fax, -1),
                                    np.moveaxis(offd_full[_axslice(4, fax, slice(0, n - 1))],
                                                fax, -1))
    dinv, l = np.moveaxis(dinv_l, -1, fax), np.moveaxis(ll, -1, fax)
    w = np.zeros_like(diag_c)
    w[_axslice(4, fax, slice(0, 1))] = gamma
    w[_axslice(4, fax, slice(n - 1, n))] += c
    wt = _tri_solve_np(dinv, l, w, axis=fax)
    denom = (1.0 + wt[_axslice(4, fax, slice(0, 1))]
             + (c / gamma) * wt[_axslice(4, fax, slice(n - 1, n))])
    return diag_c, dinv, l, wt, 1.0 / denom, (c / gamma) / denom


def stage_operands(ctx_np: Dict, key: str, ax: int, ho: bool) -> None:
    """Add the staged kernel operands of direction ``key`` (grid axis ``ax``)
    to a host context, from its ``tri_dinvm`` / ``tri_l`` (and ``alpha`` for
    k >= 1): y solve-axis-major (ny+1 / ny, nz, nx), x transposed to (nx+1 /
    nx, nz*ny); RT0 stages dm and l ("yT" / "xT"), k >= 1 also alpha ("hoyT" /
    "hoxT").  ``parallel.shard_context`` restages a rank's slab with it."""
    staged = {"dinvm": ctx_np[f"tri_dinvm_{key}"], "l": ctx_np[f"tri_l_{key}"]}
    tag = ""
    if ho:
        tag, staged["alpha"] = "ho", ctx_np[f"alpha_{key}"]
    for name, a in staged.items():
        if ax == 2:
            ctx_np[f"tri_{tag}xT_{name}_{key}"] = np.swapaxes(
                a.reshape(a.shape[0], -1, a.shape[-1]), -1, -2)
        elif ax == 1:
            ctx_np[f"tri_{tag}yT_{name}_{key}"] = np.moveaxis(a, 2, 1)


def build_context(
    fes: FESpace,
    ng: int,
    xs: Dict[str, np.ndarray],
    bcs: BCSpec,
    device,
    dtype,
    a_mode: str = "exact",
    marshak_d_factor: bool = False,
    periodic_natural: bool = False,
) -> Dict[str, torch.Tensor]:
    """Operator context of the mixed discretization on ``device``.

    ``a_mode`` selects how A (the RT mass) is inverted in the Schur product:
    "exact" (the per-direction tridiagonal solve), "diag" (A^-1 ~ 1/diag(A):
    the reference's RT0-P0 "diagonal Schur", behind its published
    eigenvalues) or "lumped" (row-sum mass lumping, mesh-centred finite
    differences); the last two at RT0 only.  ``periodic_natural`` (reference
    parity) treats PERIODIC as a natural zero-flux boundary, with a warning.
    The context is made on the host first (``build_host_context``), then
    placed (``context_to_device``)."""
    host = build_host_context(fes, ng, xs, bcs, a_mode=a_mode,
                              marshak_d_factor=marshak_d_factor,
                              periodic_natural=periodic_natural)
    return context_to_device(*host, fes.P, device, dtype)


def context_to_device(ctx_np: Dict, blk, P: int, device, dtype,
                      world=None) -> Dict[str, torch.Tensor]:
    """A host context (``build_host_context``'s two parts) as tensors on
    ``device``: every array through ``ctx_from_numpy`` (the span
    ``neutfem.context.to_device``), then, where ``blk`` holds the block-Jacobi
    ingredients (None for P == 1), the block inverse built and stored on
    ``device`` by ``_block_precond`` (``neutfem.context.blockjac``), its
    storage decision reduced over ``world`` where given (a sharded slab)."""
    with tracing.span("neutfem.context.to_device"):
        out = ctx_from_numpy(ctx_np, device, dtype)
    if blk is not None:
        out.update(_block_precond(blk, P, device, dtype, world))
    return out


def build_host_context(fes: FESpace, ng: int, xs: Dict[str, np.ndarray], bcs: BCSpec,
                       a_mode: str = "exact", marshak_d_factor: bool = False,
                       periodic_natural: bool = False):
    """``build_context``'s arrays on the host, float64: (the context as a
    dict of numpy arrays, and for P > 1 the ingredients of the P x P
    block-Jacobi blocks, None for P == 1).  The ingredients are
    ``"coefs"`` (P*P, J), the per-direction coefficient matrices stacked,
    ``"fields"`` (ng, J, nz, ny, nx), the cell fields they multiply, and
    ``"C"`` / ``"pre"`` (ng, P, nz, ny, nx), the removal term and the exact
    Schur diagonal: cell planes, which ``parallel.shard_context`` slices into
    each rank's slab as it slices every other cell field (the inverse is
    per cell).  ``context_to_device`` builds and inverts the blocks on the
    device.  Its phases are the spans ``neutfem.context.directions`` (the
    per-direction operators), ``.schur_diag`` (the exact Schur diagonal and
    the block ingredients) and ``.line`` (the line factors, where built)."""
    mesh = fes.mesh
    et = fes.et
    if a_mode not in ("exact", "diag", "lumped"):
        raise ValueError(f"unknown a_mode {a_mode!r}")
    if a_mode != "exact" and et.k != 0:
        raise ValueError("diag/lumped A-solves are only defined for RT0")

    detJ = mesh.det_jac()  # (nz, ny, nx)
    w_mode = fes.w_mode  # (P,)
    D = np.asarray(xs["D"], dtype=np.float64)
    SigR = np.asarray(xs["SigR"], dtype=np.float64)

    w_col = w_mode.reshape(1, -1, 1, 1, 1)
    C = SigR[:, None] * detJ[None, None] * w_col  # (ng, P, nz, ny, nx)
    # row-sum lumping -> mesh-centred finite differences
    K = np.diag(et.M1_lumped[:2]) if a_mode == "lumped" else et.K

    ctx_np: Dict[str, np.ndarray] = {"C": C}
    est = C.copy()  # the diag-A estimate of diag(S)
    src_bc = np.zeros_like(C)  # fixed flux-space rhs of the nonzero NEUMANN lifts
    jacs = [mesh.h_grid(a) / 2.0 for a in range(3)]  # fake axes: h=2 -> jac=1
    # directions of the line preconditioner: the highest active one ("line")
    # and the next ("line2")
    pc_dirs = sorted((di.d for di in fes.dirs), reverse=True)[:2]
    line_offd = {}  # d -> (interior off-diagonal of the pc line, its face axis)
    lr_stash = {}  # key -> the estimate's (left, right) face inverse diagonals

    with tracing.span("neutfem.context.directions"):
        for di in fes.dirs:
            d, ax = di.d, di.axis  # ax in (nz, ny, nx) order
            key = f"d{d}"
            factor = jacs[d] ** 2 / detJ  # (nz, ny, nx)
            alpha = factor[None] / D  # (ng, nz, ny, nx)

            fshape = (ng, *di.face_shape)
            fax = 1 + ax  # face axis within (ng, *face_shape)
            n_faces = di.face_shape[ax]
            tr_axes = [a for a in range(3) if a != d and mesh.active(a)]
            n_tr = len(tr_axes)
            fa = np.ones(mesh.shape)
            for a in tr_axes:
                fa = fa * mesh.h_grid(a)  # physical face area, broadcast over cells
            js_cell = jacs[d] / detJ
            m_t_of_p = di.m_t[di.p_to_t]  # (P,)
            pd = fes.modes[:, d]
            coefL = ((et.D1[pd, 0] ** 2) * m_t_of_p).reshape(1, -1, 1, 1, 1)
            coefR = ((et.D1[pd, 1] ** 2) * m_t_of_p).reshape(1, -1, 1, 1, 1)

            kinds = tuple(bcs.kind(boundary_attribute(mesh.dim, d, up)) for up in (False, True))
            if BCKind.PERIODIC in kinds and not periodic_natural:
                if kinds[0] != kinds[1]:
                    raise ValueError(f"PERIODIC must be set on BOTH ends of direction {d} "
                                     f"(got {kinds[0].name}/{kinds[1].name})")
                if a_mode != "exact":
                    raise ValueError("PERIODIC boundaries require a_mode='exact'")
                if n_faces - 1 < 2:
                    raise ValueError("PERIODIC direction needs at least 2 cells")
                diag_c, dinv, l, wt, a0, a1 = _cyclic_factors(alpha, K, fax)
                ctx_np[f"cyc_wt_{key}"] = wt
                ctx_np[f"cyc_a0_{key}"] = a0
                ctx_np[f"cyc_a1_{key}"] = a1
                ctx_np[f"alpha_{key}"] = alpha
                ctx_np[f"tri_dinv_{key}"] = dinv
                ctx_np[f"tri_l_{key}"] = l
                if di.T > 1:
                    for name, a in (("dinv", dinv), ("l", l)):
                        ctx_np[f"tri_cycT_{name}_{key}"] = np.repeat(a[:, None], di.T, axis=1)
                ctx_np[f"mask_{key}"] = np.ones(di.face_shape)
                ctx_np[f"dtilde_{key}"] = _dtilde_wrap(D, mesh.h_grid(d), fax, ax)
                ctx_np[f"area_{key}"] = fa
                ctx_np[f"jscale_{key}"] = np.concatenate(
                    [js_cell, js_cell[_axslice(3, ax, slice(-1, None))]], axis=ax)
                # the estimate with cyclic neighbours: cell i's left face is face
                # i, its right face (i + 1) % n
                inv_diag_c = 1.0 / diag_c
                left, right = inv_diag_c, np.roll(inv_diag_c, -1, axis=fax)
                lr_stash[key] = (left, right)
                est += left[:, None] * coefL + right[:, None] * coefR
                continue

            diag = np.zeros(fshape)
            # element e contributes K00 to its left face (index e) and K11 to its right (e+1)
            diag[_axslice(4, fax, slice(0, n_faces - 1))] += alpha * K[0, 0]
            diag[_axslice(4, fax, slice(1, n_faces))] += alpha * K[1, 1]
            offd = alpha * K[0, 1]  # (ng, nz, ny, nx): coupling between faces e and e+1
            mask = np.ones(di.face_shape)
            jpin = np.zeros(fshape)  # prescribed DOF values at pinned faces (t = 0)
            neumann_c = np.zeros(fshape)  # (A J_q) restricted to the free faces

            for upper in (False, True):
                attr = boundary_attribute(mesh.dim, d, upper)
                kind = bcs.kind(attr)
                f_idx = n_faces - 1 if upper else 0
                e_idx = -1 if upper else 0
                face_sl = _axslice(4, fax, f_idx)
                elem_sl = _axslice(4, fax, e_idx)
                fa_b = fa[_axslice(3, ax, e_idx)]

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
                    q = bcs.value(attr) if kind == BCKind.NEUMANN else 0.0
                    if q != 0.0:
                        # prescribed inward current density q: the essential
                        # condition J.n = -q (lower end: J_d = +q), lifted as
                        # J = J' + J_q; the DOF value (physical current over the
                        # Piola scale) and the A-coupling it sheds onto the
                        # adjacent free face, read BEFORE that coupling is zeroed
                        qdof = (q if not upper else -q) / js_cell[_axslice(3, ax, e_idx)]
                        jpin[face_sl] = qdof[None]
                        adj_sl = _axslice(4, fax, n_faces - 2 if upper else 1)
                        neumann_c[adj_sl] += offd[_axslice(4, fax, -1 if upper else 0)] * qdof[None]
                    # Pin the face: the off-diagonal out of it is zeroed BEFORE the
                    # factorization, so its l and dinv*mask are exactly 0 — the
                    # fused kernels rely on it (their rhs scale is the scalar 1/m_t).
                    mask[_axslice(3, ax, f_idx)] = 0.0
                    diag[face_sl] = 1.0
                    offd[_axslice(4, fax, -1 if upper else 0)] = 0.0
                elif kind == BCKind.PERIODIC:
                    # periodic_natural: the reference accepts PERIODIC and never
                    # discretizes it (NeutFEM.cpp:2128-2131)
                    warnings.warn(
                        "periodic_natural=True: PERIODIC treated as a natural zero-flux "
                        "boundary (reference bug-parity); the default implements true "
                        "periodic coupling", RuntimeWarning, stacklevel=2)
                # BCKind.NONE: natural => zero boundary flux, no term (reference default)

            inv_diag = mask[None] / diag
            if d in pc_dirs and fes.P == 1:
                # line preconditioner: the off-diagonal of the (diagonal-A) Schur
                # along d, S_{e,e+1} = B(e,f) B(e+1,f) / A_ff at the shared
                # interior face f = e+1
                coef = float(et.D1[0, 0] * et.D1[0, 1] * di.m_t[0])
                line_offd[d] = (coef * inv_diag[_axslice(4, fax, slice(1, n_faces - 1))], fax)

            if a_mode == "exact":
                dinv_l, ll = tridiag_ldlt_batch(np.moveaxis(diag, fax, -1),
                                                np.moveaxis(offd, fax, -1))
                dinv = np.moveaxis(dinv_l, -1, fax)
                l = np.moveaxis(ll, -1, fax)
            else:
                dinv, l = 1.0 / diag, None

            if np.any(jpin != 0.0):
                # the lift J = J' + J_q: A J' = -B^T phi - c with c = (A J_q)|free,
                # so S phi = f + B (J_q - A^-1 c); jcorr = J_q - A_free^-1 c is
                # added to the output current and B jcorr (with the solver's sign:
                # S phi = f with J = +A^-1 B^T phi) to every fixed-source rhs
                if l is not None:
                    y = _tri_solve_np(dinv, l, neumann_c, axis=fax)
                else:
                    y = neumann_c * dinv
                jcorr = jpin - y * mask[None]
                ctx_np[f"jcorr_{key}"] = jcorr
                bx0 = di.BX[0, :, 0].reshape(1, -1, 1, 1, 1)  # (P,) t = 0 pairing rows
                bx1 = di.BX[1, :, 0].reshape(1, -1, 1, 1, 1)
                src_bc = src_bc - (jcorr[_axslice(4, fax, slice(0, n_faces - 1))][:, None] * bx0
                                   + jcorr[_axslice(4, fax, slice(1, n_faces))][:, None] * bx1)

            # CMFD coupling data: Dtilde per face, the face area, the Piola scale
            h_d = mesh.h_grid(d)
            dtilde = np.zeros(fshape)
            dtilde[_axslice(4, fax, slice(1, n_faces - 1))] = (
                2.0 * D[_axslice(4, fax, slice(0, -1))] * D[_axslice(4, fax, slice(1, None))]
                / (D[_axslice(4, fax, slice(0, -1))] * h_d[_axslice(3, ax, slice(1, None))]
                   + D[_axslice(4, fax, slice(1, None))] * h_d[_axslice(3, ax, slice(0, -1))]))
            dtilde[_axslice(4, fax, 0)] = 2.0 * D[_axslice(4, fax, 0)] / h_d[_axslice(3, ax, 0)]
            dtilde[_axslice(4, fax, n_faces - 1)] = (2.0 * D[_axslice(4, fax, -1)]
                                                     / h_d[_axslice(3, ax, -1)])
            ctx_np[f"dtilde_{key}"] = dtilde
            ctx_np[f"area_{key}"] = fa
            ctx_np[f"jscale_{key}"] = np.concatenate(
                [js_cell, js_cell[_axslice(3, ax, slice(-1, None))]], axis=ax)

            # the diag-A estimate of diag(S) (the generalized diagonal-Schur
            # formula; pinned faces carry no coupling, so under "diag" it is
            # exactly S_ee = C_ee + sum_f B_ef^2 / A_ff, NeutFEM.cpp:459-473)
            left = inv_diag[_axslice(4, fax, slice(0, n_faces - 1))]
            right = inv_diag[_axslice(4, fax, slice(1, n_faces))]
            lr_stash[key] = (left, right)
            est += left[:, None] * coefL + right[:, None] * coefR

            ctx_np[f"alpha_{key}"] = alpha
            ctx_np[f"tri_dinv_{key}"] = dinv
            ctx_np[f"mask_{key}"] = mask
            if l is None:
                continue
            ctx_np[f"tri_l_{key}"] = l
            dmm = dinv * mask[None]
            ctx_np[f"tri_dinvm_{key}"] = dmm
            stage_operands(ctx_np, key, ax, et.k > 0)

    with tracing.span("neutfem.context.schur_diag"):
        blk_terms = []  # (P x P coefficient, (ng, cells) factor) of every direction
        if a_mode == "exact":
            # Exact Schur diagonal: the diag-A estimate underestimates diag(S) by up
            # to ~460x at higher orders; the per-cell quadratic form of the
            # condensed exact solve is  c^T T^-1 c / m_t + b_W^T Mbb^-1 b_W / (alpha m_t)
            # with c = b_F - G^T b_W over the element's two faces.  A periodic
            # direction keeps its diag-A estimate (neutfem_tpu/ops/context.py:471-474).
            pre = C.copy()
            for di in fes.dirs:
                key = f"d{di.d}"
                ax = di.axis
                fax = 1 + ax
                ncell = mesh.shape[ax]
                imt = 1.0 / di.m_t
                if f"cyc_wt_{key}" in ctx_np:
                    left, right = lr_stash[key]
                    M0 = np.einsum("pt,qt,t->pq", di.BX[0], di.BX[0], imt)
                    M1 = np.einsum("pt,qt,t->pq", di.BX[1], di.BX[1], imt)
                    pre += (np.diagonal(M0).reshape(1, -1, 1, 1, 1) * left[:, None]
                            + np.diagonal(M1).reshape(1, -1, 1, 1, 1) * right[:, None])
                    blk_terms += [(M0, left), (M1, right)]
                    continue
                mask_d = ctx_np[f"mask_{key}"]
                dd, od = _tinv_dd_od(ctx_np[f"tri_dinv_{key}"], ctx_np[f"tri_l_{key}"], fax)
                dd = dd * mask_d[None]
                mL = mask_d[_axslice(3, ax, slice(0, ncell))]
                mR = mask_d[_axslice(3, ax, slice(1, ncell + 1))]
                od = od * (mL * mR)[None]
                ddL = dd[_axslice(4, fax, slice(0, ncell))]
                ddR = dd[_axslice(4, fax, slice(1, ncell + 1))]
                chat = np.array(di.BX[:2], dtype=np.float64)
                if et.nbub > 0:
                    chat = chat - np.einsum("bf,bpt->fpt", et.G, di.BX[2:])
                c00 = np.einsum("pt,qt,t->pq", chat[0], chat[0], imt)
                c11 = np.einsum("pt,qt,t->pq", chat[1], chat[1], imt)
                c01 = np.einsum("pt,qt,t->pq", chat[0], chat[1], imt)
                pre += (np.diagonal(c00).reshape(1, -1, 1, 1, 1) * ddL[:, None]
                        + np.diagonal(c11).reshape(1, -1, 1, 1, 1) * ddR[:, None]
                        + 2.0 * np.diagonal(c01).reshape(1, -1, 1, 1, 1) * od[:, None])
                blk_terms += [(c00, ddL), (c11, ddR), (c01 + c01.T, od)]
                if et.nbub > 0:
                    w_pq = np.einsum("bpt,bc,cqt,t->pq", di.BX[2:], et.Mbb_inv, di.BX[2:], imt)
                    inv_alpha = 1.0 / ctx_np[f"alpha_{key}"]
                    pre += np.diagonal(w_pq).reshape(1, -1, 1, 1, 1) * inv_alpha[:, None]
                    blk_terms.append((w_pq, inv_alpha))
        else:
            pre = est

        ctx_np["precond_inv"] = 1.0 / pre
        blk = None
        if fes.P > 1:
            # the P x P per-cell block-Jacobi blocks of the higher orders: the
            # sum of the per-direction terms (P x P coefficient times a cell
            # field) plus C on the diagonal, equilibrated by the exact diagonal;
            # built and inverted on the device (``_block_precond``)
            P = fes.P
            blk = {"coefs": np.stack([c.reshape(P * P) for c, _ in blk_terms], axis=1),
                   "fields": np.stack([f for _, f in blk_terms], axis=1), "C": C, "pre": pre}
        if et.k == 0 and fes.m == 0 and os.environ.get("NEUTFEM_EQFOLD", "0") in ("1", "2"):
            # the equilibration-folded RT0 matvec's operands, in float64 then cast
            # (neutfem_tpu/ops/context.py:527-537); built only under the switch, so
            # the default path holds no extra cell planes
            sdi = 1.0 / np.sqrt(pre)
            ctx_np["precond_eq_sdi"] = sdi
            ctx_np["precond_eq_csdi"] = C * sdi
    # the line factors, where the highest active direction has them (a
    # periodic one has none, and then neither line is built: the JAX rule)
    if pc_dirs[0] in line_offd:
        with tracing.span("neutfem.context.line"):
            for name, d in zip(("line", "line2"), pc_dirs):
                if d in line_offd:
                    ctx_np[f"precond_{name}_dinv"], ctx_np[f"precond_{name}_l"] = _line_factors(
                        pre[:, 0], *line_offd[d])
    if np.any(src_bc != 0.0):
        ctx_np["src_bc"] = src_bc
    ctx_np["detJ"] = detJ
    ctx_np["w_mode"] = w_mode                           # (P,) public trailing-mode weight
    ctx_np["w_mode_col"] = w_mode.reshape(-1, 1, 1, 1)  # internal mode-first broadcast
    ctx_np["nsf"] = np.asarray(xs["NSF"], dtype=np.float64)
    ctx_np["chi"] = np.asarray(xs["Chi"], dtype=np.float64)
    ctx_np["sigs"] = np.asarray(xs["SigS"], dtype=np.float64)
    ctx_np["src"] = np.asarray(xs["SRC"], dtype=np.float64)
    ctx_np["sigr"] = SigR
    ctx_np["vol"] = mesh.volumes()
    return ctx_np, blk
