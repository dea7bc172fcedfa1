"""Fused RT0 Schur directions: acc += B_d A_d^{-1} B_d^T v in one pass — K1, K2, K3.

Port of ``neutfem_tpu/ops/pallas_fused.py`` (``fused_schur_dir`` on axis -3,
``fused_schur_y_pre``, ``fused_schur_x_pre``).  Per line along direction d
(f = face 0..n, e = cell 0..n-1; bx0/bx1 the two scalar divergence-pairing
entries, si = 1/m_t):

    rF_f  = bx1 v_{f-1} + bx0 v_f                (v out of range = 0)
    z_0   = rF_0 si;    z_f = rF_f si - l_{f-1} z_{f-1}
    F_n   = z_n dm_n;   F_f = z_f dm_f - l_f F_{f+1}          [dm = dinv*mask]
    out_e = acc_e + (bx0 F_e + bx1 F_{e+1})

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/fused_dir.cu``; on a CPU tensor it runs the plain PyTorch version.  A
CUDA tensor the kernel does not take raises; there is no decline path.

Like the TPU kernels, which alias the accumulator input to the output, the
wrappers UPDATE ``acc`` IN PLACE and return it.

Operands (v and acc single-group, every leading dim of size 1):

* z: dm (nz+1, ny, nx), l (nz, ny, nx) — the natural face layout;
* y: dmT (ny+1, nz, nx), lT (ny, nz, nx) — staged solve-axis-major;
* x: dmT (nx+1, nz*ny), lT (nx, nz*ny) — staged transposed.

In all three, the face entry f of line b sits at ``b + f*lines``.
"""

from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["fused_schur_z", "fused_schur_y_pre", "fused_schur_x_pre",
           "fused_dir_plain", "LAUNCHES", "reset_launches"]

#: Kernel launches per direction (incremented where the kernel is launched).
LAUNCHES = {"z": 0, "y": 0, "x": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_dir_plain(acc, v, dm, l, axis: int, bx0: float, bx1: float, si: float):
    """Plain PyTorch version in the natural layout: dm (n+1) and l (n) entries
    along ``axis`` of v's spatial shape, broadcastable against v.  Returns the
    new accumulator (does not touch ``acc``)."""
    axis = axis % v.ndim
    n = v.shape[axis]
    vv = v.movedim(axis, 0)
    fshape = v.shape[:axis] + (n + 1,) + v.shape[axis + 1:]
    dd = dm.expand(fshape).movedim(axis, 0)
    ll = l.expand(v.shape).movedim(axis, 0)
    z = torch.empty((n + 1,) + vv.shape[1:], dtype=v.dtype, device=v.device)
    z[0] = (bx0 * vv[0]) * si
    for f in range(1, n + 1):
        rf = bx1 * vv[f - 1]
        if f < n:
            rf = rf + bx0 * vv[f]
        z[f] = rf * si - ll[f - 1] * z[f - 1]
    F = torch.empty_like(z)
    F[n] = z[n] * dd[n]
    for e in range(n - 1, -1, -1):
        F[e] = z[e] * dd[e] - ll[e] * F[e + 1]
    contrib = bx0 * F[:n] + bx1 * F[1:]
    return acc + contrib.movedim(0, axis)


def _check(acc, v, dm, l, dm_shape, l_shape, what):
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {v.dtype}")
    if v.ndim < 3 or any(s != 1 for s in v.shape[:-3]):
        raise NotImplementedError(
            f"{what}: v must be one group's (..., nz, ny, nx) grid with unit leading dims, "
            f"got {tuple(v.shape)}")
    for name, t, shape in (("acc", acc, v.shape), ("dm", dm, dm_shape), ("l", l, l_shape)):
        if t.device != v.device or t.dtype != v.dtype:
            raise TypeError(f"{what}: {name} must be {v.dtype} on {v.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    for name, t in (("acc", acc), ("v", v), ("dm", dm), ("l", l)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch(acc, v, dm, l, n, inner, outer_stride, cell_stride, bx0, bx1, si, key):
    lines = v.numel() // n
    zs = torch.empty((n, lines), dtype=v.dtype, device=v.device)
    lib = cuda_lib.library()
    fn = lib.neutfem_fused_dir_f32 if v.dtype == torch.float32 else lib.neutfem_fused_dir_f64
    err = fn(acc.data_ptr(), v.data_ptr(), dm.data_ptr(), l.data_ptr(), zs.data_ptr(),
             n, lines, inner, outer_stride, cell_stride, float(bx0), float(bx1), float(si),
             torch.cuda.current_stream(v.device).cuda_stream)
    cuda_lib.check(err, f"fused Schur direction {key}")
    LAUNCHES[key] += 1
    return acc


def _dispatch(acc, v, dm, l, dm_shape, l_shape, to_natural, axis, strides, bx0, bx1, si,
              key):
    what = f"fused_schur_{key}"
    if v.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{what}: no kernel for device {v.device}")
    _check(acc, v, dm, l, dm_shape, l_shape, what)
    if v.device.type == "cpu":
        dm_nat, l_nat = to_natural(dm, l)
        acc.copy_(fused_dir_plain(acc, v, dm_nat, l_nat, axis, bx0, bx1, si))
        return acc
    n = v.shape[axis]
    if n < 1:
        raise ValueError(f"{what}: empty solve axis")
    return _launch(acc, v, dm, l, n, *strides, bx0, bx1, si, key)


def fused_schur_z(acc, v, dm, l, bx0: float, bx1: float, si: float):
    """acc += B_z A_z^{-1} B_z^T v (K1), in place.  dm (nz+1, ny, nx), l (nz, ny, nx)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dm, l, (nz + 1, ny, nx), (nz, ny, nx),
        lambda d_, l_: (d_, l_), -3,
        # lines (y, x) = the whole plane: inner = ny*nx, cells step by ny*nx
        (ny * nx, 0, ny * nx), bx0, bx1, si, "z")


def fused_schur_y_pre(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_y A_y^{-1} B_y^T v (K2), in place.  dmT (ny+1, nz, nx), lT (ny, nz, nx)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, (ny + 1, nz, nx), (ny, nz, nx),
        lambda d_, l_: (d_.movedim(0, -2), l_.movedim(0, -2)), -2,
        # lines (z, x): b = z*nx + x, cells at z*ny*nx + x + e*nx
        (nx, ny * nx, nx), bx0, bx1, si, "y")


def fused_schur_x_pre(acc, v, dmT, lT, bx0: float, bx1: float, si: float):
    """acc += B_x A_x^{-1} B_x^T v (K3), in place.  dmT (nx+1, nz*ny), lT (nx, nz*ny)."""
    nz, ny, nx = v.shape[-3:]
    return _dispatch(
        acc, v, dmT, lT, (nx + 1, nz * ny), (nx, nz * ny),
        lambda d_, l_: (d_.T.reshape(nz, ny, nx + 1), l_.T.reshape(nz, ny, nx)), -1,
        # lines (z, y): b = z*ny + y, cells at b*nx + e
        (1, nx, 1), bx0, bx1, si, "x")
