"""Fused block-Jacobi apply + CG dots: (z, <r, z>, <r, r>) per cell — K8.

Port of ``neutfem_tpu/ops/pallas_blockjac.py`` (``blockjac_dots``, ``_call``):
the higher-order Schur CG's P x P per-cell block-Jacobi preconditioner applied
to one group's float32 residual together with the two reductions ``pcg``
needs next, in one pass over the block tensor.  Two entries, one kernel:

* ``blockjac_dots`` on the stored inverse (float32 or bfloat16), z = B^-1 r —
  ``power.group_solve`` takes it under ``NEUTFEM_BLOCKJAC=1`` when the
  context holds ``precond_blk_inv`` (``NEUTFEM_BLKFP8=0`` at float32);
* ``blockjac_dev_dots`` on the fp8 E-form, E = B^-1 - I in float8 e4m3,
  z = r + E r with the identity part applied exactly — the default float32
  block preconditioner (``precond_blk_dev``), which the JAX package applies
  as an einsum (``neutfem_tpu/power.py:271-280``).

On a CUDA tensor each launches the tiled kernel of ``csrc/blockjac_tiled.cu``
(a block per 32*V cells, r's tile staged in shared memory, 8- or 16-byte
plane loads widened in registers; the dots accumulated in float64, per-block partials
finished by one ``torch.sum`` and rounded to float32 once, so they do not
depend on the tile; no atomics, so the result is the same bit for bit from
launch to launch) at the tile ``blockjac_tile`` picks; on a CPU tensor it runs
``blockjac_dots_plain``.  A CUDA tensor the kernel does not take raises.  A
launch counts under ``tracing``'s ``blockjac.blockjac_tiled`` (the inverse
forms) or ``blockjac.blockjac_dev`` (the E-form).

Operands: ``blk`` (P, P, nz, ny, nx); ``r`` (..., P, nz, ny, nx) float32 with
every leading dim of size 1.  Returns z shaped like r and the two dots as 0-d
float32 tensors.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import cuda_lib

__all__ = ["blockjac_dots", "blockjac_dev_dots", "blockjac_dots_plain", "blockjac_tile"]

#: The kernel's storage forms (``csrc/blockjac_tiled.cu``).
_FORMS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def blockjac_dots_plain(blk, r, deviation: bool = False):
    """Plain PyTorch version: the blocks upcast to r's dtype, one einsum, two
    sums; ``deviation``: ``blk`` is the E-form and z = r + E r."""
    P = blk.shape[0]
    rc = r.reshape(P, -1)
    z = torch.einsum("pqc,qc->pc", blk.reshape(P, P, -1).to(r.dtype), rc)
    z = (rc + z if deviation else z).contiguous()
    return z.reshape(r.shape), torch.sum(rc * z), torch.sum(rc * rc)


def blockjac_tile(P: int):
    """(wide, warps) of the tiled kernel for P x P blocks: 8-byte plane
    loads (wide 0: a tile of 32 * 8 / itemsize cells, twice the blocks of
    the 16-byte tile), and the most warps up to 9 that split the P rows
    evenly (9 at P = 27, 8 at P = 8).  In chip_smoke.py [3]'s sweeps at
    RT2-P2 the best tile or within 2% of it for both storage forms
    (PERF.md)."""
    return 0, max(w for w in range(1, 10) if P % w == 0)


def _check(blk, r, what):
    if blk.ndim < 3 or blk.shape[0] != blk.shape[1]:
        raise ValueError(f"{what}: blocks must be (P, P, *spatial), got {tuple(blk.shape)}")
    P, spatial = blk.shape[0], tuple(blk.shape[2:])
    n = len(spatial) + 1
    if tuple(r.shape[-n:]) != (P, *spatial) or any(s != 1 for s in r.shape[:-n]):
        raise ValueError(f"{what}: r {tuple(r.shape)} does not match the blocks "
                         f"{tuple(blk.shape)} (one group's (..., P, *spatial))")
    if blk.device != r.device:
        raise TypeError(f"{what}: blocks and r on different devices")


def _launch(blk, r, key, what, tile=None):
    if r.device.type != "cuda":
        raise NotImplementedError(f"{what}: no kernel for device {r.device}")
    if r.dtype != torch.float32:
        raise TypeError(f"{what}: r must be float32, got {r.dtype}")
    if not (blk.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"{what}: blocks and r must be contiguous")
    P = blk.shape[0]
    cells = r.numel() // P
    wide, warps = tile or blockjac_tile(P)
    per_tile = 32 * (16 if wide else 8) // blk.element_size()
    z = torch.empty_like(r)
    part = torch.empty((-(-cells // per_tile), 2), dtype=torch.float64, device=r.device)
    err = cuda_lib.library().neutfem_blockjac_tiled(
        _FORMS[blk.dtype], blk.data_ptr(), r.data_ptr(), z.data_ptr(), part.data_ptr(), P,
        cells, wide, warps, torch.cuda.current_stream(r.device).cuda_stream)
    cuda_lib.check(err, f"{what} (tiled kernel, P {P}, tile {(wide, warps)})")
    tracing.count(f"blockjac.{key}")
    rz, rr = torch.sum(part, dim=0).to(torch.float32)
    return z, rz, rr


def blockjac_dots(bi, r, tile=None):
    """(z, rz, rr): z = einsum('pq...,q...->p...', bi, r), rz = <r, z>, rr = <r, r>,
    on the inverse ``bi`` (float32 or bfloat16).  ``tile``: (wide, warps) in
    place of ``blockjac_tile``'s."""
    _check(bi, r, "blockjac_dots")
    if r.device.type == "cpu":
        return blockjac_dots_plain(bi, r)
    if bi.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"blockjac_dots: bi must be bfloat16 or float32, got {bi.dtype}")
    return _launch(bi, r, "blockjac_tiled", "blockjac_dots", tile)


def blockjac_dev_dots(dev, r, tile=None):
    """(z, rz, rr) with z = r + einsum('pq...,q...->p...', dev, r) on the
    E-form ``dev`` = B^-1 - I (float8_e4m3fn), rz = <r, z>, rr = <r, r>."""
    _check(dev, r, "blockjac_dev_dots")
    if r.device.type == "cpu":
        return blockjac_dots_plain(dev, r, deviation=True)
    if dev.dtype != torch.float8_e4m3fn:
        raise TypeError(f"blockjac_dev_dots: dev must be float8_e4m3fn, got {dev.dtype}")
    return _launch(dev, r, "blockjac_dev", "blockjac_dev_dots", tile)
