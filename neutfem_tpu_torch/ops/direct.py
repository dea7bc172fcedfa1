"""Explicit (dense) Schur complement of one group (port of ``neutfem_tpu/ops/direct.py``).

``dense_schur_group`` materializes S = C + sum_d B_d A_d^{-1} B_d^T column by
column by applying the matrix-free ``schur_matvec`` to identity columns.  The
JAX package vmaps the matvec over the identity; here the columns are a leading
batch dimension of the unfused matvec, taken a chunk at a time so memory stays
bounded.  The two-grid preconditioner uses it at build time on the coarse
level.  The direct solver of the reference's explicit-Schur path
(``attach_dense_schur``, ``direct_solve``) is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from .apply import schur_matvec

__all__ = ["dense_schur_group"]

#: Identity columns per batched matvec (bounds the intermediates at
#: chunk x n_phi values each).
COLUMN_CHUNK = 512


def dense_schur_group(fes, ctxg: Dict, a_mode: str = "exact"):
    """The (n_phi, n_phi) Schur complement of ONE group (``ctxg`` group-sliced),
    symmetrized as 0.5 (S + S^T) for the Cholesky factorization."""
    shape = (fes.P, *fes.mesh.shape)  # internal mode-first layout
    n = fes.n_phi
    C = ctxg["C"]
    S = torch.empty((n, n), dtype=C.dtype, device=C.device)
    for j0 in range(0, n, COLUMN_CHUNK):
        m = min(COLUMN_CHUNK, n - j0)
        cols = torch.zeros((m, n), dtype=C.dtype, device=C.device)
        cols[torch.arange(m, device=C.device), torch.arange(j0, j0 + m, device=C.device)] = 1.0
        # row i of S is S e_i (S is symmetric up to rounding)
        S[j0:j0 + m] = schur_matvec(fes, ctxg, cols.reshape(m, *shape), a_mode=a_mode,
                                    fused=False).reshape(m, n)
    return 0.5 * (S + S.T)
