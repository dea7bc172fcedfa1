"""The chunked recurrence of the tiled K2 / K3 kernel (csrc/fused_rows.cu),
transcribed in plain PyTorch, against the plain version ``fused_dir_plain``
and the JAX package's ``fused_schur_y_pre`` / ``fused_schur_x_pre`` in
interpret mode (float64, CPU).

The transcription follows the kernel step by step: the line's n+1 faces are
cut into ``ch`` chunks of an odd length; each chunk runs its recurrence from
0 and keeps its end value and the product of its multipliers (pass 1); the
carries come from a Hillis-Steele scan over the chunks, as the kernel's warp
shuffles compute them; each chunk reruns from its carry (pass 2); forward
for z, then backward for F, then the divergence.  The card tests
(tests/test_torch_gpu.py) hold the kernel itself against ``fused_dir_plain``.
Tolerance: rel <= 1e-12 (the same sums in another association).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu.ops.pallas_fused import fused_schur_x_pre, fused_schur_y_pre
from neutfem_tpu_torch.ops import fused

torch.set_num_threads(1)

BX0, BX1, SI = 0.7, -0.9, 0.35
SHAPES = {"2d": (1, 515, 45), "3d": (8, 64, 64)}  # (nz, ny, nx)


def _scan(y, A, reverse):
    """Inclusive scan of the chunks' (A, E) pairs over axis 0, log2 steps,
    every chunk reading its partner's value from before the step."""
    ch = y.shape[0]
    d = 1
    while d < ch:
        y0, A0 = y.clone(), A.clone()
        if reverse:  # chunk c takes the later chunk c + d
            y[:-d] = y0[:-d] + A0[:-d] * y0[d:]
            A[:-d] = A0[:-d] * A0[d:]
        else:  # chunk c takes the earlier chunk c - d
            y[d:] = y0[d:] + A0[d:] * y0[:-d]
            A[d:] = A0[d:] * A0[:-d]
        d *= 2
    carry = torch.zeros_like(y)
    if reverse:
        carry[:-1] = y[1:]
    else:
        carry[1:] = y[:-1]
    return carry


def _chunked(b, a, ch, reverse):
    """y_k = b_k + a_k y_(k-1) over axis 0 (from the end when ``reverse``),
    chunk by chunk as the kernel runs it."""
    faces, lines = b.shape
    ln = -(-faces // ch)
    ln += 1 - ln % 2  # odd, as the kernel's tile_layout
    pad = ch * ln - faces  # past the end: b = 0, a = 1, the identity step
    bp = torch.cat([b, b.new_zeros((pad, lines))]).reshape(ch, ln, lines)
    ap = torch.cat([a, a.new_ones((pad, lines))]).reshape(ch, ln, lines)
    steps = range(ln - 1, -1, -1) if reverse else range(ln)
    y, A = b.new_zeros((ch, lines)), b.new_ones((ch, lines))
    for k in steps:  # pass 1
        y = bp[:, k] + ap[:, k] * y
        A = A * ap[:, k]
    y = _scan(y, A, reverse)
    out = torch.empty_like(bp)
    for k in steps:  # pass 2
        y = bp[:, k] + ap[:, k] * y
        out[:, k] = y
    return out.reshape(ch * ln, lines)[:faces]


def chunked_dir(acc, v, dm, l, ch):
    """acc + B A^{-1} B^T v on solve-axis-major (n, lines) v and acc, dm
    (n+1, lines), l (n, lines), with ``ch`` chunks per line."""
    zero = v.new_zeros((1, v.shape[1]))
    b = (BX1 * torch.cat([zero, v]) + BX0 * torch.cat([v, zero])) * SI
    z = _chunked(b, torch.cat([zero, -l]), ch, reverse=False)
    F = _chunked(z * dm, torch.cat([-l, zero]), ch, reverse=True)
    return acc + (BX0 * F[:-1] + BX1 * F[1:])


@pytest.fixture(scope="module", params=[(s, d) for s in SHAPES for d in ("y", "x")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """Operands of one direction, staged as the wrappers take them, the
    plain version's result and the JAX kernel's (None where it declines:
    the y kernel needs nz >= 4)."""
    shape_key, d = request.param
    nz, ny, nx = SHAPES[shape_key]
    n, lines = (ny, nz * nx) if d == "y" else (nx, nz * ny)
    rng = np.random.default_rng(7)
    v, acc = rng.standard_normal((2, 1, nz, ny, nx))
    dmT = rng.uniform(0.2, 0.6, (n + 1, lines))
    lT = rng.uniform(-0.3, 0.3, (n, lines))
    dmT[0] = 0.0  # a pinned first face (zero current: l = dm = 0 there)
    lT[0] = 0.0
    if d == "y":
        staged = (dmT.reshape(n + 1, nz, nx), lT.reshape(n, nz, nx))
        jfn, wrapper = fused_schur_y_pre, fused.fused_schur_y_pre
        lines_of = lambda a: a.reshape(nz, ny, nx).transpose(1, 0, 2).reshape(ny, -1)  # noqa: E731
        from_lines = lambda a: a.reshape(ny, nz, nx).transpose(1, 0, 2)  # noqa: E731
    else:
        staged = (dmT, lT)
        jfn, wrapper = fused_schur_x_pre, fused.fused_schur_x_pre
        lines_of = lambda a: a.reshape(-1, nx).T  # noqa: E731
        from_lines = lambda a: a.T.reshape(nz, ny, nx)  # noqa: E731
    plain = wrapper(torch.tensor(acc), torch.tensor(v),
                    *(torch.tensor(np.ascontiguousarray(a)) for a in staged), BX0, BX1, SI)
    want = jfn(jnp.asarray(acc), jnp.asarray(v), *(jnp.asarray(a) for a in staged),
               BX0, BX1, SI, interpret=True)
    assert (want is None) == (d == "y" and nz < 4), "the JAX kernel's gate moved"
    T = torch.tensor
    ops = (T(np.ascontiguousarray(lines_of(acc))), T(np.ascontiguousarray(lines_of(v))),
           T(dmT), T(lT))
    return ops, from_lines, plain.numpy()[0], None if want is None else np.asarray(want)[0]


def _rel(got, want, base):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want - base)))


@pytest.mark.parametrize("ch", [1, 5, 8, 32, 128])
def test_chunked_recurrence_matches_plain_and_jax(case, ch):
    """ch 1 is the unchunked recurrence; 8 and 32 divide n = 64 (3d) and
    not n = 45 or 515 (2d), 5 divides none; 128 leaves chunks empty."""
    (acc, v, dm, l), from_lines, plain, want = case
    got = from_lines(chunked_dir(acc, v, dm, l, ch).numpy())
    acc_nat = from_lines(acc.numpy())
    assert _rel(got, plain, acc_nat) <= 1e-12
    if want is not None:
        assert _rel(got, want, acc_nat) <= 1e-12


def test_rows_tile_fits_the_paths_shapes():
    """The tiled kernel's tile at the paths' line lengths (ZION 912, KOEBERG
    544, IAEA-3D 6x6x4 114 and 8x8x8 152, IAEA-3D 1x1 19) fits the card's
    shared memory at its full lines per block; very long lines halve it; a
    line no tile holds gets one line per block, which the card refuses."""
    for dtype in (torch.float32, torch.float64):
        elem = torch.finfo(dtype).bits // 8
        for n in (912, 544, 152, 114, 19, 1):
            tl, ch = fused.rows_tile(912, n, dtype)
            assert (tl, ch) == (fused.ROWS_LINES[dtype], fused.ROWS_CHUNKS)
            assert fused.rows_smem(n, tl, ch, elem) <= fused.SMEM_PER_BLOCK
        tl, ch = fused.rows_tile(1, 4000, dtype)
        assert 1 <= tl < fused.ROWS_LINES[dtype]
        assert fused.rows_smem(4000, tl, ch, elem) <= fused.SMEM_PER_BLOCK
        assert fused.rows_tile(1, 25000, dtype)[0] == 1
        assert fused.rows_smem(25000, 1, ch, elem) > fused.SMEM_PER_BLOCK
