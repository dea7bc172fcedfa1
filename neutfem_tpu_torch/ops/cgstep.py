"""The masked PCG step's elementwise and scalar work, in two kernels.

``krylov._pcg_parts.step`` computes, around its matvec and preconditioner,

* ``cg_xr`` (after q = A p and pq = <p, q>): the masked alpha, x + alpha p,
  r - alpha q and, where the caller reduces <r, r> itself, the product
  vector r * r that ``torch.sum`` then reduces;
* ``cg_p`` (after z = M r and the dots rz', rr'): the masked beta,
  p = z + beta p, and the next 0-d state (rz, rr, it, go).

On a CUDA tensor each launches its kernel of ``csrc/cg_step.cu``
(``cg_step_xr_kernel``, ``cg_step_p_kernel``: flat over numel, float32 or
float64, every product and sum rounded on its own, so the results equal the
plain versions' bit for bit); a CUDA operand the kernel does not take
raises; a launch counts under ``tracing``'s ``cgstep.cg_xr`` /
``cgstep.cg_p``.  On a CPU tensor each runs its plain version, the step's own
PyTorch expressions.  The 0-d operands stay on the device: the kernels
read them there, so the step needs no host read and is captured whole in
``krylov.CGGraph``.  The JAX package has no counterpart kernel: its step
is one XLA fusion inside the CG's ``while_loop``.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import cuda_lib

__all__ = ["cg_xr", "cg_p", "cg_xr_plain", "cg_p_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _breakdown(pq):
    return torch.abs(pq) <= torch.finfo(pq.dtype).tiny


def cg_xr_plain(x, r, p, q, pq, rz, go, rr: bool = True):
    """(x + alpha p, r - alpha q, r' * r' or None), alpha = rz / pq where
    ``go`` holds and |pq| > tiny, else 0."""
    breakdown = _breakdown(pq)
    alpha = torch.where(go & ~breakdown, rz / torch.where(breakdown, 1.0, pq), 0.0)
    x = x + alpha * p
    r = r - alpha * q
    return x, r, (r * r if rr else None)


def cg_p_plain(z, p, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, maxiter: int):
    """(z + beta p, rz, rr, it, go) of the next state: beta = rz_new / rz
    (a zero rz read as 1) where ``go`` holds, else 0; rz, rr and it move
    only where ``go`` holds; go stays true while pq is no breakdown,
    rr > tol_sq and it < maxiter."""
    beta = torch.where(go, rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
    it = it + go
    rr = torch.where(go, rr_new, rr)
    return (z + beta * p, torch.where(go, rz_new, rz), rr, it,
            go & ~_breakdown(pq) & (rr > tol_sq) & (it < maxiter))


def _check(what, vectors, scalars, go):
    """The kernel's operands: contiguous vectors of one shape, float32 or
    float64, and 0-d operands of their dtype, all on one CUDA device."""
    v0 = vectors[0]
    if v0.dtype not in _SUFFIX:
        raise TypeError(f"{what}: vectors must be float32 or float64, got {v0.dtype}")
    for t in vectors:
        if t.device != v0.device or t.dtype != v0.dtype or t.shape != v0.shape:
            raise ValueError(f"{what}: vectors differ in device, dtype or shape "
                             f"({t.device}, {t.dtype}, {tuple(t.shape)} against "
                             f"{v0.device}, {v0.dtype}, {tuple(v0.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: vectors must be contiguous")
    for t in scalars:
        if t.numel() != 1 or t.device != v0.device or t.dtype != v0.dtype:
            raise ValueError(f"{what}: a 0-d operand must be one {v0.dtype} value on "
                             f"{v0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if go.numel() != 1 or go.dtype != torch.bool or go.device != v0.device:
        raise ValueError(f"{what}: go must be one bool on {v0.device}")


def _fn(name, dtype):
    return getattr(cuda_lib.library(), f"neutfem_{name}_{_SUFFIX[dtype]}")


def cg_xr(x, r, p, q, pq, rz, go, rr: bool = True):
    """``cg_xr_plain`` on the CPU; on the card one launch of
    ``cg_step_xr_kernel`` (``rr``: also write r' * r')."""
    if x.device.type == "cpu":
        return cg_xr_plain(x, r, p, q, pq, rz, go, rr)
    _check("cg_xr", (x, r, p, q), (pq, rz), go)
    xo, ro = torch.empty_like(x), torch.empty_like(r)
    rro = torch.empty_like(r) if rr else None
    err = _fn("cg_xr", x.dtype)(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(), xo.data_ptr(), ro.data_ptr(),
        rro.data_ptr() if rr else None, x.numel(), pq.data_ptr(), rz.data_ptr(), go.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, f"cg_xr ({x.numel()} values, {x.dtype})")
    tracing.count("cgstep.cg_xr")
    return xo, ro, rro


def cg_p(z, p, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, maxiter: int):
    """``cg_p_plain`` on the CPU; on the card one launch of
    ``cg_step_p_kernel``, its 0-d results in tensors of their own.
    ``tol_sq`` may be float32 or float64 (compared in the wider dtype, as
    torch compares), ``it`` is int32."""
    if z.device.type == "cpu":
        return cg_p_plain(z, p, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, maxiter)
    _check("cg_p", (z, p), (pq, rz, rz_new, rr_new, rr), go)
    if it.numel() != 1 or it.dtype != torch.int32 or it.device != z.device:
        raise ValueError(f"cg_p: it must be one int32 on {z.device}")
    if tol_sq.numel() != 1 or tol_sq.dtype not in _SUFFIX or tol_sq.device != z.device:
        raise ValueError(f"cg_p: tol_sq must be one float32 or float64 on {z.device}")
    po = torch.empty_like(z)
    rz_o, rr_o = (torch.empty((), dtype=z.dtype, device=z.device) for _ in range(2))
    it_o = torch.empty((), dtype=torch.int32, device=z.device)
    go_o = torch.empty((), dtype=torch.bool, device=z.device)
    err = _fn("cg_p", z.dtype)(
        z.data_ptr(), p.data_ptr(), po.data_ptr(), z.numel(), pq.data_ptr(), rz.data_ptr(),
        rz_new.data_ptr(), rr_new.data_ptr(), rr.data_ptr(), it.data_ptr(), go.data_ptr(),
        tol_sq.data_ptr(), int(tol_sq.dtype == torch.float64), maxiter, rz_o.data_ptr(),
        rr_o.data_ptr(), it_o.data_ptr(), go_o.data_ptr(),
        torch.cuda.current_stream(z.device).cuda_stream)
    cuda_lib.check(err, f"cg_p ({z.numel()} values, {z.dtype})")
    tracing.count("cgstep.cg_p")
    return po, rz_o, rr_o, it_o, go_o
