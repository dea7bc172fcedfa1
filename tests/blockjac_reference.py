"""The former host build of the port's block-Jacobi preconditioner, the
plain reference of its device build (``ops/context._block_precond``): the
blocks assembled and inverted per cell in numpy float64 with
``np.linalg.inv``, the float8 storage test in float32 one row of blocks at a
time, and the storage rule.  Imports neither JAX nor the JAX package (the
card tests use it)."""

import numpy as np
import torch

#: Below this magnitude a stored entry is float64 rounding noise of an exact
#: zero: an equilibrated block's inverse has O(1) entries, and two LU
#: libraries part by ~1e-15 there (IAEA-3D RT2-P2 1x1x1: 1.3e-15 at most),
#: while a structurally zero entry comes out as +-1e-18 ... 1e-35.
NOISE = 1e-12


def reference_inverse(blk, P, shape):
    """The former host build: (the equilibrated block inverse (ng, P, P,
    *shape) in float64, whether float32 stores its deviation in float8)."""
    coefs, fields, C, pre = blk["coefs"], blk["fields"], blk["C"], blk["pre"]
    ng = fields.shape[0]
    idx = np.arange(P)
    blk_inv = np.empty((ng, P, P) + tuple(shape))
    for g in range(ng):
        b = (coefs @ fields[g].reshape(fields.shape[1], -1)).reshape(P, P, -1)
        b[idx, idx] += C[g].reshape(P, -1)
        sdi = 1.0 / np.sqrt(pre[g].reshape(P, -1))
        bh = np.moveaxis(b * sdi[:, None] * sdi[None, :], -1, 0)
        blk_inv[g] = np.moveaxis(np.linalg.inv(bh), 0, -1).reshape((P, P) + tuple(shape))
    return blk_inv, reference_emax(blk_inv) < 440.0


def reference_emax(blk_inv):
    """max|Binv - I| in float32 arithmetic, one row of blocks at a time."""
    emax = 0.0
    for g in range(blk_inv.shape[0]):
        for i in range(blk_inv.shape[1]):
            row = blk_inv[g, i].astype(np.float32)
            row[i] -= np.float32(1.0)
            emax = max(emax, float(np.max(np.abs(row))))
    return emax


def reference_store(blk_inv, fp8, P, dtype, blkfp8="1"):
    """The former storage rule on the reference inverse."""
    bi = torch.from_numpy(np.ascontiguousarray(blk_inv)).to(dtype=dtype)
    if dtype != torch.float32:
        return {"precond_blk_inv": bi}
    if fp8 and blkfp8 != "0":
        eye = torch.eye(P, dtype=dtype).reshape(1, P, P, 1, 1, 1)
        return {"precond_blk_dev": (bi - eye).to(torch.float8_e4m3fn)}
    return {"precond_blk_inv": bi.to(torch.bfloat16)}


def _bits(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


def assert_same_storage(got, want):
    """``got`` holds ``want``'s bytes, except where both are below ``NOISE``:
    there the sign of an fp8 zero, or a bfloat16 value of ~1e-18, is what the
    LU's rounding made of an exact zero (no apply can tell an fp8 -0 from
    +0: a product with it adds nothing)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.cpu().float(), want.cpu().float()
    noise = (g.abs() < NOISE) & (w.abs() < NOISE)
    assert torch.equal(_bits(got.cpu())[~noise], _bits(want.cpu())[~noise])
