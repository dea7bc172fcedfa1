"""DOF layout for the mixed RT_k / P_m pair as structured grids.

Port of ``neutfem_tpu/fespace.py`` (host-side numpy; the JAX ``zeros_state``
helper is not carried over).

PUBLIC (caller-facing, reference-shaped) layout:

* flux:  ``phi``      shape ``(ng, nz, ny, nx, P)``,  ``P = prod_d (m+1 if d active)``
* J faces, direction d: shape ``(ng, ..., n_d + 1, ..., T_d)`` — the face axis has one
  more entry than the cell axis; ``T_d = (k+1)^{#active transverse axes}``.

INTERNAL (solver) layout is mode-axis-FIRST — ``(ng, P, nz, ny, nx)`` /
``(ng, T, faces...)`` — see ops/apply.py for the converters.

Key structural facts (Legendre orthogonality of the transverse profiles):

1. The RT mass matrix A is block-diagonal over directions AND over transverse modes;
   a transverse mode only contributes the scalar ``m_t = prod 2/(2t+1)``.  Hence one
   tridiagonal factorization per (group, direction) serves every transverse mode.
2. The divergence pairing B couples flux mode p with J transverse mode t only when the
   transverse multi-indices agree (guaranteed representable since m <= k).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

import numpy as np

from .elements import ElementTensors, element_tensors
from .mesh import CartesianMesh

__all__ = ["FESpace", "DirectionInfo", "make_fespace", "GRID_AXIS"]

# Grid axis (within (nz, ny, nx)) that direction d runs along.
GRID_AXIS = {0: 2, 1: 1, 2: 0}  # x -> last, y -> middle, z -> first


@dataclasses.dataclass(frozen=True)
class DirectionInfo:
    """Per-direction metadata for an active direction d."""

    d: int                      # 0=x, 1=y, 2=z
    axis: int                   # spatial axis in (nz, ny, nx) order
    T: int                      # number of transverse modes
    m_t: np.ndarray             # (T,) transverse mass per mode
    BX: np.ndarray              # (nlong, P, T) divergence pairing tensor
    face_shape: Tuple[int, ...]  # spatial shape of face grid (no ng, no T)
    p_to_t: np.ndarray          # (P,) flux mode p -> transverse mode index
    # Condensed-matvec constants for k >= 1 (see neutfem_tpu/fespace.py):
    # BXc == BX[:2] and Qbub is None for k = 0.
    BXc: np.ndarray             # (2, P, T)
    Qbub: np.ndarray            # (P, P) or None


@dataclasses.dataclass(frozen=True)
class FESpace:
    mesh: CartesianMesh
    k: int                      # RT order
    m: int                      # flux order
    et: ElementTensors
    P: int                      # flux modes per element
    modes: np.ndarray           # (P, 3) multi-indices (px, py, pz); inactive axes 0
    w_mode: np.ndarray          # (P,) tensor Legendre mass weight per mode
    dirs: Tuple[DirectionInfo, ...]

    @property
    def n_phi(self) -> int:
        return self.mesh.n_elements * self.P

    @property
    def n_J(self) -> int:
        n = 0
        for di in self.dirs:
            n += int(np.prod(di.face_shape)) * di.T
            n += self.mesh.n_elements * self.et.nbub * di.T
        return n


def _transverse_axes(d: int, mesh: CartesianMesh) -> List[int]:
    return [a for a in range(3) if a != d and mesh.active(a)]


def make_fespace(mesh: CartesianMesh, k: int, m: int) -> FESpace:
    if m > k:
        # Reference inf-sup guard (NeutFEM.cpp:149-169): flux order forced down to k.
        m = k
    et = element_tensors(k, m)

    # Flux modes: multi-indices over active axes only.
    ranges = [range(m + 1) if mesh.active(a) else range(1) for a in range(3)]
    # x fastest: iterate (pz, py, px) outer->inner, store as (px, py, pz)
    modes = np.array(
        [(px, py, pz) for pz in ranges[2] for py in ranges[1] for px in ranges[0]],
        dtype=np.int64,
    )
    P = modes.shape[0]
    w_mode = np.ones(P)
    for a in range(3):
        if mesh.active(a):
            w_mode *= et.leg_mass[modes[:, a]]

    dirs = []
    for d in range(3):
        if not mesh.active(d):
            continue
        tr_axes = _transverse_axes(d, mesh)
        # transverse mode tuples, first transverse axis fastest
        t_tuples = list(itertools.product(*[range(k + 1)] * len(tr_axes)))
        if len(tr_axes) == 2:
            # order: t = t0 + (k+1) * t1 with t0 the lower axis index
            t_tuples = [
                (t0, t1) for t1 in range(k + 1) for t0 in range(k + 1)
            ]
        T = len(t_tuples)
        m_t = np.ones(T)
        for j, tt in enumerate(t_tuples):
            for t_val in tt:
                m_t[j] *= et.leg_mass[t_val]

        t_index = {tt: j for j, tt in enumerate(t_tuples)}
        p_to_t = np.zeros(P, dtype=np.int64)
        for p in range(P):
            key = tuple(int(modes[p, a]) for a in tr_axes)
            p_to_t[p] = t_index[key]

        # BX[i, p, t] = D1[p_d, i] * prod(leg_mass[p_tr]) * delta(trans(p) == t)
        BX = np.zeros((et.nlong, P, T))
        for p in range(P):
            pd = int(modes[p, d])
            tr_mass = 1.0
            for a in tr_axes:
                tr_mass *= et.leg_mass[int(modes[p, a])]
            BX[:, p, p_to_t[p]] = et.D1[pd, :] * tr_mass

        if et.nbub > 0:
            BXc = BX[:2] - np.einsum("bf,bpt->fpt", et.G, BX[2:])
            Qbub = np.einsum("bpt,bc,cqt,t->pq", BX[2:], et.Mbb_inv, BX[2:], 1.0 / m_t)
        else:
            BXc, Qbub = BX[:2], None

        shape = list(mesh.shape)
        shape[GRID_AXIS[d]] += 1
        dirs.append(
            DirectionInfo(
                d=d,
                axis=GRID_AXIS[d],
                T=T,
                m_t=m_t,
                BX=BX,
                face_shape=tuple(shape),
                p_to_t=p_to_t,
                BXc=BXc,
                Qbub=Qbub,
            )
        )

    return FESpace(mesh=mesh, k=k, m=m, et=et, P=P, modes=modes, w_mode=w_mode, dirs=tuple(dirs))
