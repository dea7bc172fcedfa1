"""The chunked first-order recurrence of the tiled kernels (csrc/fused_rows.cu,
csrc/fused_ho_rows.cu, csrc/fused_eq_rows.cu, csrc/fused_z_rows.cu,
csrc/thomas_rows.cu), transcribed in plain PyTorch for the CPU tests.

A line's faces are cut into ``ch`` chunks of an odd length; each chunk runs
its recurrence y_k = b_k + a_k y_(k-1) from 0 and keeps its end value and the
product of its multipliers (pass 1); the carries come from a Hillis-Steele
scan over the chunks, as the kernels' warp shuffles compute them, or, for
csrc/fused_z_rows.cu and csrc/thomas_rows.cu, from the chunks before each
one composed in order (``serial``); each chunk reruns from its carry (pass
2).  ``thomas`` is the tiled Thomas solve's two sweeps on one tile.
"""

import torch


def scan(y, A, reverse):
    """Carries of the chunks' (A, E) pairs over axis 0: an inclusive scan in
    log2 steps, every chunk reading its partner's value from before the step,
    then shifted by one chunk."""
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


def serial(y, A, reverse):
    """Carries of the chunks' (A, E) pairs over axis 0, each composed from
    the chunks before it (after it when ``reverse``) in order, E_j + A_j *
    carry, starting from 0."""
    ch = y.shape[0]
    carry = torch.zeros_like(y)
    for c in range(ch):
        order = range(ch - 1, c, -1) if reverse else range(c)
        for j in order:
            carry[c] = y[j] + A[j] * carry[c]
    return carry


def chunked(b, a, ch, reverse, carries=scan):
    """y_k = b_k + a_k y_(k-1) over axis 0 of (faces, lines) b and a (from the
    end when ``reverse``), chunk by chunk as the kernels run it; ``carries``
    the chunks' composition (``scan`` or ``serial``)."""
    faces, lines = b.shape
    ln = -(-faces // ch)
    ln += 1 - ln % 2  # odd, as the kernels' tile_layout
    pad = ch * ln - faces  # past the end: b = 0, a = 1, the identity step
    bp = torch.cat([b, b.new_zeros((pad, lines))]).reshape(ch, ln, lines)
    ap = torch.cat([a, a.new_ones((pad, lines))]).reshape(ch, ln, lines)
    steps = range(ln - 1, -1, -1) if reverse else range(ln)
    y, A = b.new_zeros((ch, lines)), b.new_ones((ch, lines))
    for k in steps:  # pass 1
        y = bp[:, k] + ap[:, k] * y
        A = A * ap[:, k]
    y = carries(y, A, reverse)
    out = torch.empty_like(bp)
    for k in steps:  # pass 2
        y = bp[:, k] + ap[:, k] * y
        out[:, k] = y
    return out.reshape(ch * ln, lines)[:faces]


def thomas(r, d, l, ch, carries=serial):
    """The LDL^T solve of csrc/thomas_rows.cu on (n, lines) r and d and
    (n-1, lines) l, ``ch`` chunks per line: the forward sweep z_k = r_k -
    l_(k-1) z_(k-1), then the backward x_k = z_k d_k - l_k x_(k+1) from the
    last chunk, each chunked with ``carries`` (the kernel's: ``serial``)."""
    zero = r.new_zeros((1, r.shape[1]))
    z = chunked(r, torch.cat([zero, -l]), ch, False, carries)
    return chunked(z * d, torch.cat([-l, zero]), ch, True, carries)
