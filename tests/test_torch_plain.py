"""The plain versions of the port's line kernels against their face-by-face
loops, bit for bit.

``fused.fused_dir_plain`` (K1-K3, K5, K7), ``fused_ho.fused_ho_plain`` (K6)
and ``thomas.thomas_solve_plain`` (K4, K4') are what the CPU runs and what
the card's kernels are held to.  They compute the parts of a line that carry
nothing (the face right-hand sides, the diagonal scaling) for every face at
once and loop only over the carries, in place.  Each entry still takes the
same floating-point operations in the same order as in the loops below, so
the results are equal, not close: float32 and float64, every axis, operands
full and broadcast.
"""

import numpy as np
import pytest
import torch

from neutfem_tpu_torch.ops import fused, fused_ho, thomas

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _fused_dir_loop(acc, v, dm, l, axis, bx0, bx1, si):
    """K1-K3's recurrence face by face (``fused_dir_plain``'s former body)."""
    axis = axis % v.ndim
    n = v.shape[axis]
    vv = v.movedim(axis, 0)
    fshape = v.shape[:axis] + (n + 1,) + v.shape[axis + 1:]
    dd = dm.expand(fshape).movedim(axis, 0)
    ll = l.expand(v.shape).movedim(axis, 0)
    z = torch.empty((n + 1,) + vv.shape[1:], dtype=v.dtype)
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
    return acc + (bx0 * F[:n] + bx1 * F[1:]).movedim(0, axis)


def _thomas_loop(rhs, dinv, l, axis):
    """K4's LDL^T solve row by row (``thomas_solve_plain``'s former body)."""
    r, d, ll = rhs.movedim(axis, 0), dinv.movedim(axis, 0), l.movedim(axis, 0)
    n = r.shape[0]
    out = torch.empty_like(r)
    out[0] = r[0]
    for i in range(1, n):
        out[i] = r[i] - ll[i - 1] * out[i - 1]
    out[n - 1] = out[n - 1] * d[n - 1]
    for j in range(n - 2, -1, -1):
        out[j] = out[j] * d[j] - ll[j] * out[j + 1]
    return out.movedim(0, axis).contiguous()


def _fused_ho_loop(acc, v, dm, l, alpha, axis, tables):
    """K6's recurrence face by face (``fused_ho_plain``'s former body)."""
    sp, P = v.shape[-3:], v.shape[-4]
    ax = axis % 3
    n = sp[ax]
    T, K1 = tables.pidx.shape
    dt = v.dtype
    pidx = torch.as_tensor(tables.pidx.reshape(-1))
    vt = v.reshape(P, *sp)[pidx].reshape(T, K1, *sp).movedim(2 + ax, 0)
    fshape = list(sp)
    fshape[ax] = n + 1
    dd = dm.expand(fshape).movedim(ax, 0).unsqueeze(1)
    ll = l.expand(sp).movedim(ax, 0).unsqueeze(1)
    aa = alpha.expand(sp).movedim(ax, 0).unsqueeze(1).unsqueeze(1)
    bshape = (T, K1) + (1,) * (vt.ndim - 3)
    bxs0, bxs1 = (torch.as_tensor(tables.bxs[:, i], dtype=dt).reshape(bshape) for i in (0, 1))
    bxo0, bxo1 = (torch.as_tensor(tables.bxo[:, i], dtype=dt).reshape(bshape) for i in (0, 1))
    qt = torch.as_tensor(tables.qt, dtype=dt)
    z = torch.empty((n + 1,) + vt.shape[1:2] + vt.shape[3:], dtype=dt)
    z[0] = torch.sum(bxs0 * vt[0], dim=1)
    for f in range(1, n + 1):
        rf = torch.sum(bxs1 * vt[f - 1], dim=1)
        if f < n:
            rf = rf + torch.sum(bxs0 * vt[f], dim=1)
        z[f] = rf - ll[f - 1] * z[f - 1]
    F = torch.empty_like(z)
    F[n] = z[n] * dd[n]
    for e in range(n - 1, -1, -1):
        F[e] = z[e] * dd[e] - ll[e] * F[e + 1]
    Fs = F.unsqueeze(2)
    qv = torch.einsum("tlm,etm...->etl...", qt, vt)
    contrib = bxo0 * Fs[:n] + bxo1 * Fs[1:] + qv / aa
    out = torch.empty((P, *sp), dtype=dt)
    out[pidx] = contrib.movedim(0, 2 + ax).reshape(P, *sp)
    return acc + out.reshape(v.shape)


def _t(rng, shape, dtype, lo=None, hi=None):
    a = rng.standard_normal(shape) if lo is None else rng.uniform(lo, hi, shape)
    return torch.tensor(a, dtype=dtype)


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("axis", [-3, -2, -1])
@pytest.mark.parametrize("shape,broadcast", [((1, 5, 7, 9), False), ((2, 1, 4, 6, 3), False),
                                             ((1, 6, 5, 8), True), ((1, 1, 1, 11), False)])
def test_fused_dir_plain_equals_the_face_loop(prec, axis, shape, broadcast):
    dt = DTYPES[prec]
    rng = np.random.default_rng(abs(axis) + len(shape))
    v, acc = _t(rng, shape, dt), _t(rng, shape, dt)
    fshape = list(shape)
    fshape[axis] += 1
    dm, l = _t(rng, fshape, dt, 0.2, 0.6), _t(rng, shape, dt, -0.3, 0.3)
    if broadcast:  # the operands one entry wide across the last axis but the solve axis
        keep = -1 if axis != -1 else -2
        dm, l = dm.narrow(keep, 0, 1), l.narrow(keep, 0, 1)
    got = fused.fused_dir_plain(acc, v, dm, l, axis, 0.7, -1.3, 0.9)
    assert torch.equal(got, _fused_dir_loop(acc, v, dm, l, axis, 0.7, -1.3, 0.9))


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("axis", [-3, -2, -1])
def test_thomas_solve_plain_equals_the_row_loop(prec, axis):
    dt = DTYPES[prec]
    rng = np.random.default_rng(10 + abs(axis))
    shape = (2, 1, 5, 7, 6)
    lshape = list(shape)
    lshape[axis] -= 1
    r, d = _t(rng, shape, dt), _t(rng, shape, dt, 0.2, 0.6)
    l = _t(rng, lshape, dt, -0.3, 0.3)
    got = thomas.thomas_solve_plain(r, d, l, axis)
    assert got.is_contiguous() and torch.equal(got, _thomas_loop(r, d, l, axis))


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("axis", [-3, -2, -1])
@pytest.mark.parametrize("K1", [2, 3])
def test_fused_ho_plain_equals_the_face_loop(prec, axis, K1):
    dt = DTYPES[prec]
    rng = np.random.default_rng(20 + K1 + abs(axis))
    sp = (4, 5, 3)
    T, P = K1 * K1, K1 ** 3
    tables = fused_ho.HoTables(rng.standard_normal((T, 2, K1)), rng.standard_normal((T, 2, K1)),
                               rng.standard_normal((T, K1, K1)),
                               rng.permutation(P).reshape(T, K1))
    v, acc = _t(rng, (1, P, *sp), dt), _t(rng, (1, P, *sp), dt)
    fshape = list(sp)
    fshape[axis] += 1
    dm, l, alpha = _t(rng, fshape, dt, 0.2, 0.6), _t(rng, sp, dt, -0.3, 0.3), _t(
        rng, sp, dt, 0.5, 2.0)
    got = fused_ho.fused_ho_plain(acc, v, dm, l, alpha, axis, tables)
    assert torch.equal(got, _fused_ho_loop(acc, v, dm, l, alpha, axis, tables))
