"""Fused block-Jacobi apply + CG dots: (z, <r, z>, <r, r>) with z = B^-1 r per cell — K8.

Port of ``neutfem_tpu/ops/pallas_blockjac.py`` (``blockjac_dots``, ``_call``):
the higher-order Schur CG's P x P per-cell block-Jacobi inverse applied to the
residual together with the two reductions ``pcg`` needs next, in one pass over
the block tensor.  ``power.group_solve`` takes it under ``NEUTFEM_BLOCKJAC=1``
when the context stores the inverse as ``precond_blk_inv`` (``NEUTFEM_BLKFP8=0``
at float32: bfloat16), for a float32 residual of one group.

On a CUDA tensor ``blockjac_dots`` launches the hand-written kernel of
``csrc/blockjac.cu`` (one thread per cell, bf16 widened in registers, per-block
partial dots finished by one ``torch.sum``; no atomics, so the result is the
same bit for bit from launch to launch); on a CPU tensor it runs
``blockjac_dots_plain``.  A CUDA tensor the kernel does not take raises.

Operands: ``bi`` (P, P, nz, ny, nx) bfloat16 or float32; ``r`` (..., P, nz, ny,
nx) float32 with every leading dim of size 1.  Returns z shaped like r and the
two dots as 0-d float32 tensors.
"""

from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["blockjac_dots", "blockjac_dots_plain", "LAUNCHES", "reset_launches"]

#: Kernel launches (incremented where the kernel is launched).
LAUNCHES = {"blockjac": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def blockjac_dots_plain(bi, r):
    """Plain PyTorch version: the blocks upcast to r's dtype, one einsum, two sums."""
    P = bi.shape[0]
    rc = r.reshape(P, -1)
    z = torch.einsum("pqc,qc->pc", bi.reshape(P, P, -1).to(r.dtype), rc).contiguous()
    return z.reshape(r.shape), torch.sum(rc * z), torch.sum(rc * rc)


def _check(bi, r):
    if bi.ndim < 3 or bi.shape[0] != bi.shape[1]:
        raise ValueError(f"blockjac_dots: bi must be (P, P, *spatial), got {tuple(bi.shape)}")
    P, spatial = bi.shape[0], tuple(bi.shape[2:])
    n = len(spatial) + 1
    if tuple(r.shape[-n:]) != (P, *spatial) or any(s != 1 for s in r.shape[:-n]):
        raise ValueError(f"blockjac_dots: r {tuple(r.shape)} does not match bi "
                         f"{tuple(bi.shape)} (one group's (..., P, *spatial))")
    if bi.device != r.device:
        raise TypeError("blockjac_dots: bi and r on different devices")


def blockjac_dots(bi, r):
    """(z, rz, rr): z = einsum('pq...,q...->p...', bi, r), rz = <r, z>, rr = <r, r>."""
    _check(bi, r)
    if r.device.type == "cpu":
        return blockjac_dots_plain(bi, r)
    if r.device.type != "cuda":
        raise NotImplementedError(f"blockjac_dots: no kernel for device {r.device}")
    if r.dtype != torch.float32:
        raise TypeError(f"blockjac_dots: r must be float32, got {r.dtype}")
    if bi.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"blockjac_dots: bi must be bfloat16 or float32, got {bi.dtype}")
    if not (bi.is_contiguous() and r.is_contiguous()):
        raise ValueError("blockjac_dots: bi and r must be contiguous")
    P = bi.shape[0]
    cells = r.numel() // P
    lib = cuda_lib.library()
    z = torch.empty_like(r)
    part = torch.empty((lib.neutfem_blockjac_blocks(cells), 2), dtype=torch.float32,
                       device=r.device)
    fn = lib.neutfem_blockjac_bf16 if bi.dtype == torch.bfloat16 else lib.neutfem_blockjac_f32
    err = fn(bi.data_ptr(), r.data_ptr(), z.data_ptr(), part.data_ptr(), P, cells,
             torch.cuda.current_stream(r.device).cuda_stream)
    cuda_lib.check(err, "blockjac_dots")
    LAUNCHES["blockjac"] += 1
    rz, rr = torch.sum(part, dim=0)
    return z, rz, rr
