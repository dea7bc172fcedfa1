"""Host-side LDL^T factorization of batched tridiagonal systems (numpy).

Port of the numpy path of ``neutfem_tpu/native.py``; the JAX package's optional
ctypes host library is not carried over.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["tridiag_ldlt_batch"]


def tridiag_ldlt_batch(diag: np.ndarray, off: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """LDL^T of batched SPD tridiagonal systems.

    diag: (..., n); off: (..., n-1) along the LAST axis.
    Returns (dinv, l) with the same shapes: inverse pivots and multipliers.
    """
    n = diag.shape[-1]
    d = np.ascontiguousarray(diag, dtype=np.float64).copy()
    l = np.ascontiguousarray(off, dtype=np.float64).copy()
    batch = int(np.prod(d.shape[:-1])) if d.ndim > 1 else 1
    d2 = d.reshape(batch, n)
    l2 = l.reshape(batch, n - 1)
    dp = d2[:, 0].copy()
    for i in range(n - 1):
        li = l2[:, i] / dp
        dn = d2[:, i + 1] - l2[:, i] * li
        l2[:, i] = li
        d2[:, i] = 1.0 / dp
        dp = dn
    d2[:, n - 1] = 1.0 / dp
    return d, l
