"""Fused condensed Schur direction for k >= 1: acc += (B_d A_d^{-1} B_d^T + Qbub/alpha) v — K6.

Port of ``neutfem_tpu/ops/pallas_fused_ho.py`` (``fused_ho_dir``: ``_fused_z_ho``,
``_fused_y_ho``, ``_fused_x_ho``).  The bubble algebra of the higher-order
Schur direction folds into per-transverse-mode constants (``ho_coeff_tables``);
per transverse mode t and line along direction d (f = face 0..n, e = cell
0..n-1, l over the K1 = m+1 longitudinal flux modes of t):

    rf_f     = sum_l bxs[t,1,l] v[l,f-1] + bxs[t,0,l] v[l,f]     (v out of range = 0)
    z_0      = rf_0;      z_f = rf_f - l_{f-1} z_{f-1}
    F_n      = z_n dm_n;  F_e = z_e dm_e - l_e F_{e+1}             [dm = dinv*mask]
    out[l,e] = acc[l,e] + bxo[t,0,l] F_e + bxo[t,1,l] F_{e+1}
               + (sum_l' qt[t,l,l'] v[l',e]) / alpha_e

Pinned faces need no mask plane: the context zeroes the off-diagonal next to
a pinned face before factoring, so there l = 0 and dm = 0.

On a CUDA tensor each wrapper launches the hand-written tiled kernel of
``csrc/fused_ho_rows.cu`` (a tile of lines and a group of transverse modes
per block, each (transverse mode, line) cut into chunks, staged through
shared memory) at the tile ``ho_tile`` picks; on a CPU tensor it runs
``fused_ho_plain``.  A CUDA tensor the kernel does not take, or a launch the
card refuses, raises; there is no decline path.  A launch counts under
``tracing``'s ``fused_ho.ho_<direction>_rows``.  Like the
TPU kernels, which alias the accumulator input to the output, the wrappers
UPDATE ``acc`` IN PLACE and return it.

Operands (v and acc one group's internal flux (..., P, nz, ny, nx), every
leading dim of size 1, P = K1^3):

* z: dm (nz+1, ny, nx), l and alpha (nz, ny, nx) — the natural layout;
* y: dmT (ny+1, nz, nx), lT and aT (ny, nz, nx) — ``tri_hoyT_*``;
* x: dmT (nx+1, nz*ny), lT and aT (nx, nz*ny) — ``tri_hoxT_*``.

In all three, the face entry f of line b sits at ``b + f*lines``.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import cuda_lib
from .fused import SMEM_PER_BLOCK, row_stride

__all__ = ["HoTables", "ho_coeff_tables", "ho_tables", "kernel_mode_index",
           "fused_ho_z", "fused_ho_y", "fused_ho_x", "fused_ho_plain", "ho_tile", "ho_smem"]

#: Longitudinal orders the CUDA kernels are instantiated for (RT1-P1, RT2-P2).
KERNEL_K1 = (2, 3)

#: Lines per block of the tiled kernel, chunks per (transverse mode, line),
#: and transverse modes per block by K1: the best or within 4% of the best
#: tile chip_smoke.py [3] sweeps at IAEA-3D 4x4x2 RT2-P2 and RT1-P1 on an H100,
#: but at RT1-P1 z and y (PERF.md).
HO_LINES = 16
HO_CHUNKS = 8
HO_MODES = {2: 2, 3: 1}


def ho_coeff_tables(fes, di):
    """(bxs, bxo, qt) numpy coefficient tables for direction ``di``, or None when
    the mode structure does not factor (m != k, or no bubbles):

    bxs[t, f, l] = BXc[f, p(l,t), t] / m_t[t]   (rhs side, transverse mass folded)
    bxo[t, f, l] = BXc[f, p(l,t), t]            (output side)
    qt[t, l, l'] = Qbub[p(l,t), p(l',t)]        (condensed bubble block per t)
    """
    pidx = _mode_groups(fes, di)
    if pidx is None:
        return None
    T, K1 = pidx.shape
    bxs = np.zeros((T, 2, K1))
    bxo = np.zeros((T, 2, K1))
    qt = np.zeros((T, K1, K1))
    for t in range(T):
        for li, p in enumerate(pidx[t]):
            bxo[t, :, li] = di.BXc[:, p, t]
            bxs[t, :, li] = di.BXc[:, p, t] / di.m_t[t]
            for lj, p2 in enumerate(pidx[t]):
                qt[t, li, lj] = di.Qbub[p, p2]
    return bxs, bxo, qt


def _mode_groups(fes, di):
    """(T, K1) flux mode p of (transverse mode t, longitudinal index l), from the
    FE space's own p -> t map, or None when the modes do not factor."""
    if fes.m != fes.k or fes.et.nbub == 0:
        return None
    K1 = fes.m + 1
    groups = [[] for _ in range(di.T)]
    for p in range(fes.P):
        groups[int(di.p_to_t[p])].append(p)
    if any(len(ps) != K1 for ps in groups):
        return None
    return np.array([sorted(ps, key=lambda p: int(fes.modes[p, di.d])) for ps in groups])


class HoTables(NamedTuple):
    """Everything a K6 call needs besides its tensors."""

    bxs: np.ndarray   # (T, 2, K1)
    bxo: np.ndarray   # (T, 2, K1)
    qt: np.ndarray    # (T, K1, K1)
    pidx: np.ndarray  # (T, K1) flux mode of (t, l), from fespace's p_to_t

    @property
    def K1(self) -> int:
        return self.pidx.shape[1]

    def packed(self) -> np.ndarray:
        """(T, 4*K1 + K1^2) rows [bxs0, bxs1, bxo0, bxo1, qt] — the kernel's table."""
        T = self.pidx.shape[0]
        return np.concatenate([self.bxs.reshape(T, -1), self.bxo.reshape(T, -1),
                               self.qt.reshape(T, -1)], axis=1)


_TABLES: dict = {}  # id(di) -> (weak reference to di, HoTables or None)


def _forget(di_key: int, tables_key: int) -> None:
    """Drop a freed direction's tables and their copies on the device."""
    _TABLES.pop(di_key, None)
    for key in [k for k in _DEVICE_TABLES if k[0] == tables_key]:
        del _DEVICE_TABLES[key]


def ho_tables(fes, di):
    """``HoTables`` of direction ``di``, or None (see ``ho_coeff_tables``);
    built once per direction object (the matvec asks every CG iteration) and
    dropped, with their copies on the device, when the direction is freed."""
    hit = _TABLES.get(id(di))
    if hit is None or hit[0]() is not di:
        tabs = ho_coeff_tables(fes, di)
        hit = (weakref.ref(di), None if tabs is None else HoTables(*tabs, _mode_groups(fes, di)))
        _TABLES[id(di)] = hit
        weakref.finalize(di, _forget, id(di), id(hit[1]))
    return hit[1]


def kernel_mode_index(K1: int, axis: int) -> np.ndarray:
    """(T, K1) flux mode that the CUDA kernel addresses for (t, l) on spatial
    ``axis`` (0 = z, 1 = y, 2 = x): P splits as (K1[pz], K1[py], K1[px]) with x
    fastest, l is the solve axis's own exponent (stride K1^(2-axis)) and
    t = t_lo + K1 t_hi runs over the other two, lower stride first.  Mirrors
    the index arithmetic of ``csrc/fused_ho_rows.cu``, so the CPU tests can
    hold it against the FE space's p -> t map."""
    lstride = K1 ** (2 - axis)
    s_lo = K1 if lstride == 1 else 1
    s_hi = K1 if lstride == K1 * K1 else K1 * K1
    t = np.arange(K1 * K1)[:, None]
    return np.arange(K1)[None, :] * lstride + (t % K1) * s_lo + (t // K1) * s_hi


def fused_ho_plain(acc, v, dm, l, alpha, axis: int, tables: HoTables):
    """Plain PyTorch version in the natural layout: ``axis`` is the solve axis
    of v's spatial shape (-3 z, -2 y, -1 x); dm (n+1 along it), l and alpha
    (n) broadcast against the spatial grid.  Takes the mode grouping from
    ``tables.pidx`` (the FE space's p -> t map).  Returns the new accumulator
    (does not touch ``acc``)."""
    sp = v.shape[-3:]
    P = v.shape[-4]
    ax = axis % 3
    n = sp[ax]
    T, K1 = tables.pidx.shape
    dt, dev = v.dtype, v.device

    def t_(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    pidx = torch.as_tensor(tables.pidx.reshape(-1), device=dev)
    # (n, T, K1, rest...) with the solve axis leading
    vt = v.reshape(P, *sp)[pidx].reshape(T, K1, *sp).movedim(2 + ax, 0)
    fshape = list(sp)
    fshape[ax] = n + 1
    dd = dm.expand(fshape).movedim(ax, 0).unsqueeze(1)   # (n+1, 1, rest...)
    ll = l.expand(sp).movedim(ax, 0).unsqueeze(1)        # (n, 1, rest...)
    aa = alpha.expand(sp).movedim(ax, 0).unsqueeze(1).unsqueeze(1)  # (n, 1, 1, rest)
    bshape = (T, K1) + (1,) * (vt.ndim - 3)
    bxs0, bxs1 = t_(tables.bxs[:, 0]).reshape(bshape), t_(tables.bxs[:, 1]).reshape(bshape)
    bxo0, bxo1 = t_(tables.bxo[:, 0]).reshape(bshape), t_(tables.bxo[:, 1]).reshape(bshape)
    qt = t_(tables.qt)  # (T, K1, K1)

    # every face's rhs at once, then only the carries run as a loop (each
    # entry takes the same operations, in the same order, as face by face)
    z = torch.empty((n + 1,) + vt.shape[1:2] + vt.shape[3:], dtype=dt, device=dev)
    z[0] = torch.sum(bxs0 * vt[0], dim=1)
    z[1:] = torch.sum(bxs1 * vt, dim=2)
    z[1:n] += torch.sum(bxs0 * vt[1:], dim=2)
    lls, zs = ll.unbind(0), z.unbind(0)
    tmp = torch.empty_like(zs[0])
    for f in range(1, n + 1):
        torch.mul(lls[f - 1], zs[f - 1], out=tmp)
        zs[f].sub_(tmp)
    F = z * dd
    Fe = F.unbind(0)
    for e in range(n - 1, -1, -1):
        torch.mul(lls[e], Fe[e + 1], out=tmp)
        Fe[e].sub_(tmp)
    Fs = F.unsqueeze(2)  # (n+1, T, 1, rest...)
    qv = torch.einsum("tlm,etm...->etl...", qt, vt)
    contrib = bxo0 * Fs[:n] + bxo1 * Fs[1:] + qv / aa  # (n, T, K1, rest...)
    out = torch.empty((P, *sp), dtype=dt, device=dev)
    out[pidx] = contrib.movedim(0, 2 + ax).reshape(P, *sp)
    return acc + out.reshape(v.shape)


def ho_smem(n: int, tl: int, ch: int, tg: int, K1: int, elem_bytes: int) -> int:
    """Shared memory bytes of one block of the tiled kernel: rows of
    ``fused.row_stride`` for the K1 mode planes of v and of acc and the z / F
    row of each of the ``tg`` transverse modes, and the dm, l and alpha rows,
    of each line; plus the tg rows of the coefficient table and the line
    offsets."""
    rows = (tg * (2 * K1 + 1) + 3) * tl
    return 8 * tl + (tg * (4 * K1 + K1 * K1) + rows * row_stride(n, tl, ch)) * elem_bytes


def ho_tile(lines: int, n: int, K1: int, dtype):
    """(lines per block, chunks per (transverse mode, line), transverse modes
    per block) of the tiled kernel for ``lines`` lines of ``n`` cells.  A
    fixed rule on the shape: ``HO_LINES`` lines of ``HO_CHUNKS`` chunks and
    ``HO_MODES[K1]`` modes, the lines halved while the block exceeds the
    card's shared memory, the chunks doubled so that a warp still holds whole
    lines (lines x chunks >= 32); at one line per block a tile that does not
    fit is refused by the card and raises."""
    tl, ch, tg = HO_LINES, HO_CHUNKS, HO_MODES[K1]
    elem = torch.finfo(dtype).bits // 8
    while tl > 1 and ho_smem(n, tl, ch, tg, K1, elem) > SMEM_PER_BLOCK:
        tl //= 2
        ch = max(ch, 32 // tl)
    return tl, ch, tg


def _check(v, named, K1, what):
    """Validate v and the (name, tensor, shape) operands the kernel reads."""
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {v.dtype}")
    if v.ndim < 4 or any(s != 1 for s in v.shape[:-4]):
        raise NotImplementedError(
            f"{what}: v must be one group's (..., P, nz, ny, nx) flux with unit leading dims, "
            f"got {tuple(v.shape)}")
    if v.shape[-4] != K1 ** 3:
        raise ValueError(f"{what}: P = {v.shape[-4]} is not K1^3 = {K1 ** 3}")
    if not v.is_contiguous():
        raise ValueError(f"{what}: v must be contiguous")
    for name, t, shape in named:
        if t.device != v.device or t.dtype != v.dtype:
            raise TypeError(f"{what}: {name} must be {v.dtype} on {v.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


_DEVICE_TABLES: dict = {}  # (id(tables), dtype, device) -> (tables, tensor)


def _device_table(tables: HoTables, dtype, device):
    """The packed coefficient table on the device, made once per (tables, dtype,
    device): a host-to-device copy per launch would synchronize the stream."""
    key = (id(tables), dtype, str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None or hit[0] is not tables:
        with tracing.sync("upload"):
            hit = (tables, torch.tensor(tables.packed(), dtype=dtype, device=device))
        _DEVICE_TABLES[key] = hit
    return hit[1]


def _launch(acc, v, dm, l, alpha, tables, n, lines, inner, outer_stride, cell_stride,
            axis, key):
    K1 = tables.K1
    if K1 not in KERNEL_K1:
        raise NotImplementedError(f"fused_{key}: no kernel for K1 = {K1} (orders {KERNEL_K1})")
    if n < 1:
        raise ValueError(f"fused_{key}: empty solve axis")
    tab = _device_table(tables, v.dtype, v.device)
    tile = ho_tile(lines, n, K1, v.dtype)
    lib = cuda_lib.library()
    fn = (lib.neutfem_fused_ho_rows_f32 if v.dtype == torch.float32
          else lib.neutfem_fused_ho_rows_f64)
    plane = v.shape[-3] * v.shape[-2] * v.shape[-1]
    err = fn(acc.data_ptr(), v.data_ptr(), dm.data_ptr(), l.data_ptr(), alpha.data_ptr(),
             tab.data_ptr(), K1, 2 - axis, n, lines, inner, outer_stride, cell_stride, plane,
             *tile, torch.cuda.current_stream(v.device).cuda_stream)
    cuda_lib.check(err, f"fused condensed Schur direction {key} (tiled kernel, tile {tile}, "
                        f"n {n})")
    tracing.count(f"fused_ho.{key}_rows")
    return acc


def _dispatch(acc, v, dm, l, alpha, tables, shapes, to_natural, axis, strides, key):
    what = f"fused_{key}"
    if v.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{what}: no kernel for device {v.device}")
    _check(v, [("acc", acc, v.shape), ("dm", dm, shapes[0]), ("l", l, shapes[1]),
               ("alpha", alpha, shapes[2])], tables.K1, what)
    if v.device.type == "cpu":
        acc.copy_(fused_ho_plain(acc, v, *to_natural(dm, l, alpha), axis, tables))
        return acc
    n = v.shape[axis]
    lines = v.shape[-3] * v.shape[-2] * v.shape[-1] // n
    return _launch(acc, v, dm, l, alpha, tables, n, lines, *strides, axis % 3, key)


def fused_ho_z(acc, v, dm, l, alpha, tables: HoTables):
    """acc += condensed z direction (K6), in place.  dm (nz+1, ny, nx), l/alpha (nz, ny, nx)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dm, l, alpha, tables, ((nz + 1, ny, nx), (nz, ny, nx), (nz, ny, nx)),
        lambda d_, l_, a_: (d_, l_, a_), -3,
        # lines (y, x) = the whole plane: inner = ny*nx, cells step by ny*nx
        (ny * nx, 0, ny * nx), "ho_z")


def fused_ho_y(acc, v, dmT, lT, aT, tables: HoTables):
    """acc += condensed y direction (K6), in place.  dmT (ny+1, nz, nx), lT/aT (ny, nz, nx)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, aT, tables, ((ny + 1, nz, nx), (ny, nz, nx), (ny, nz, nx)),
        lambda d_, l_, a_: (d_.movedim(0, -2), l_.movedim(0, -2), a_.movedim(0, -2)), -2,
        # lines (z, x): b = z*nx + x, cells at z*ny*nx + x + e*nx
        (nx, ny * nx, nx), "ho_y")


def fused_ho_x(acc, v, dmT, lT, aT, tables: HoTables):
    """acc += condensed x direction (K6), in place.  dmT (nx+1, nz*ny), lT/aT (nx, nz*ny)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, aT, tables, ((nx + 1, nz * ny), (nx, nz * ny), (nx, nz * ny)),
        lambda d_, l_, a_: (d_.T.reshape(nz, ny, nx + 1), l_.T.reshape(nz, ny, nx),
                            a_.T.reshape(nz, ny, nx)), -1,
        # lines (z, y): b = z*ny + y, cells at b*nx + e
        (1, nx, 1), "ho_x")
