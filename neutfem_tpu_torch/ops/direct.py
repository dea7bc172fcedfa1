"""Explicit (dense) Schur complement and direct solve (port of ``neutfem_tpu/ops/direct.py``).

The analogue of the reference's explicit-Schur path (solvers.cpp:259-427),
``SchurSolver::SetMatrices`` forming S = C + B A^{-1} B^T column by column for a
direct solver:

* ``dense_schur_group`` materializes S of one group by applying the matrix-free
  ``schur_matvec`` to identity columns.  The JAX package vmaps the matvec over
  the identity; here the columns are a leading batch dimension of the unfused
  matvec, taken a chunk at a time so memory stays bounded.  The two-grid
  preconditioner uses it at build time on the coarse level;
* ``attach_dense_schur`` factors the symmetrically Jacobi-equilibrated
  D^-1/2 S D^-1/2 (unit diagonal: float32-safe with the 1e15 void absorbers)
  by Cholesky, per group, and stores the factors on the context;
* ``direct_solve`` is then two triangular solves per group solve.

The factorization and the triangular solves are library calls
(``torch.linalg.cholesky``, ``torch.linalg.solve_triangular``), as the JAX
package leaves them to ``jnp.linalg``.  Dense S is O(n_phi^2) memory, so the
facade gates this path to n_phi <= ``NEUTFEM_DIRECT_MAX_NPHI`` (default
``DIRECT_MAX_NPHI``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..shardctx import current_sharding, gather_slabs, take_slab
from .apply import schur_matvec

__all__ = ["dense_schur_group", "attach_dense_schur", "direct_solve", "DIRECT_MAX_NPHI"]

#: Default gate of the dense path (override: NEUTFEM_DIRECT_MAX_NPHI); 4096^2
#: float32 = 64 MB per group.
DIRECT_MAX_NPHI = 4096

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


def _equilibrated_cholesky(S):
    """Cholesky factor of D^-1/2 S D^-1/2 and D^-1/2 (D = diag(S))."""
    d = torch.diagonal(S)
    sdi = 1.0 / torch.sqrt(torch.where(d <= 0, 1.0, d))
    return torch.linalg.cholesky(S * sdi[:, None] * sdi[None, :]), sdi


def attach_dense_schur(fes, ctx: Dict, a_mode: str = "exact") -> None:
    """Build the per-group dense Schur factors and store them in ``ctx``
    (idempotent): ``schur_chol`` (ng, n, n) and ``schur_sdi`` (ng, n) — the
    ``schur_`` prefix is group-sliced by ``power.ctx_group``."""
    if "schur_chol" in ctx:
        return
    from ..power import ctx_group

    Ls, sdis = [], []
    for g in range(ctx["C"].shape[0]):
        L, sdi = _equilibrated_cholesky(dense_schur_group(fes, ctx_group(ctx, g), a_mode))
        Ls.append(L)
        sdis.append(sdi)
    ctx["schur_chol"] = torch.stack(Ls)
    ctx["schur_sdi"] = torch.stack(sdis)


def direct_solve(ctxg: Dict, rhs):
    """x = S^-1 rhs from the equilibrated Cholesky factors: solve
    S_hat y = D^-1/2 rhs, then x = D^-1/2 y.  One group (L (n, n)) or the
    Jacobi sweep's batch (L (ng, n, n), rhs with a leading group axis).

    Under a sharding scope ``rhs`` is the rank's slab and the factors are
    whole on every rank (``parallel.shard_context``, the JAX package's
    replicated ``schur_*``): the slabs are all-gathered over the world, every
    rank runs the two triangular solves of the whole system, and keeps its
    slab of x.  The dense path is gated to small problems (the facade's
    ``DIRECT_MAX_NPHI``), so the gather is small."""
    sh = current_sharding()
    if sh is None:
        return _solve(ctxg, rhs)
    base = rhs.ndim - 3
    return take_slab(_solve(ctxg, gather_slabs(rhs, *sh, base)), *sh, base)


def _solve(ctxg: Dict, rhs):
    L, sdi = ctxg["schur_chol"], ctxg["schur_sdi"]
    b = (rhs.reshape(*L.shape[:-2], -1) * sdi).unsqueeze(-1)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    y = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True).squeeze(-1)
    return (y * sdi).reshape(rhs.shape)
