"""The plain reference: residuals of the mixed RT_k-P_k k-eigenvalue problem
on the answer a solve returned.

Plain numpy in float64.  It assembles the discrete operators itself, from
the inputs the benchmark handed to both sides and the element tensors of
``fem.py``, and applies them to the program's answer (k, the flux moments
phi and the current J, in the facade's public layout, the arrays its
``save_state`` writes).  It takes no operator, factor or scaling that the
program made.

For each group g and direction d, in the DOF units of the facade's state:

* Fick's law, ``A_d J_d = B_d^T phi_g``: A_d is the RT mass, element by
  element ``alpha_e m_t M1`` on (left face, right face, bubbles) with
  ``alpha_e = (h_d/2)^2 / detJ / D``, plus the Marshak vacuum term ``m_t 2 D
  2^n_tr / face area`` on each outer face (the reference code's
  coefficient, NeutFEM.cpp:1350); ``B_d^T phi`` pairs each element's flux
  moments with its faces and bubbles (``fem.Direction.BX``);
* the balance ``C phi_g + sum_d B_d J_d = chi_g / k F phi + S phi``, with
  ``C = Sigma_r detJ w``, ``F phi = sum_g' nuSigma_f detJ w phi_g'`` and the
  scattering from the other groups.

Reported numbers (all relative, the largest over groups and directions):

* ``fick_res``: ||A_d J_d - B_d^T phi|| / ||B_d^T phi||;
* ``balance_res``: the balance residual over its source, each row scaled by
  1 / sqrt(C + each pairing row squared over A's lumped face mass and bubble
  diagonal), an estimate of diag(S) standing for the Jacobi equilibration
  the CG's own stop test uses: unscaled, the rows of IAEA-3D's 1e15
  absorber, where the flux is ~0, would swamp the rest;
* ``k_gap``: |k - k_rq| / k_rq, with k_rq the Rayleigh quotient of the
  returned flux and current, <phi, chi F phi> / <phi, C phi + B J - S phi>
  over every DOF; exact for an exact eigenpair, and blind to the absorber's
  rows, which phi ~ 0 weights out.

The lower-precision control (``bfloat16_control``) is this reference put in
the program's place: the flux held in bfloat16, the current worked out from
it by the reference's own Fick solve (``fick_solve``, exact in float64), and
k its Rayleigh quotient, an answer consistent in everything but the flux's
precision.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .fem import Direction, Space, make_space

__all__ = ["Operators", "judge", "round_to_bfloat16", "bfloat16_control"]


def _ratio(num: float, den: float) -> float:
    """sqrt(num / den); infinite where it is not a finite number (a zero
    denominator, a NaN), so that such a reading fails every limit."""
    r = float(np.sqrt(num / den)) if den > 0 else float("inf")
    return r if np.isfinite(r) else float("inf")


def _sl(ndim: int, axis: int, s) -> tuple:
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


class Operators:
    """The discrete operators of one configuration's inputs."""

    def __init__(self, inputs, k: int):
        self.space: Space = make_space(inputs.dim, k)
        xs = inputs.xs
        self.D = xs["D"]
        self.sigr = xs["SigR"]
        self.nsf = xs["NSF"]
        self.chi = xs["Chi"]
        self.sigs = xs["SigS"]
        self.ng = self.D.shape[0]
        fake = np.array([2.0])
        hx = np.diff(inputs.x_breaks)
        hy = np.diff(inputs.y_breaks)
        hz = np.diff(inputs.z_breaks) if inputs.dim == 3 else fake
        shape = self.D.shape[1:]
        self.h = [np.broadcast_to(hx[None, None, :], shape),
                  np.broadcast_to(hy[None, :, None], shape),
                  np.broadcast_to(hz[:, None, None], shape)]
        self.detJ = (self.h[0] / 2) * (self.h[1] / 2) * (self.h[2] / 2)

    # -- one direction --------------------------------------------------------

    def BT(self, di: Direction, phi):
        """B_d^T phi: face part (ng, faces..., T), bubble part (ng, cells..., nb, T)."""
        fax = 1 + di.axis
        c0 = phi @ di.BX[0]  # element's left face
        c1 = phi @ di.BX[1]  # element's right face
        shape = list(c0.shape)
        shape[fax] += 1
        rF = np.zeros(shape)
        n = c0.shape[fax]
        rF[_sl(rF.ndim, fax, slice(0, n))] += c0
        rF[_sl(rF.ndim, fax, slice(1, n + 1))] += c1
        rW = np.einsum("...p,lpt->...lt", phi, di.BX[2:]) if self.space.k else None
        return rF, rW

    def A(self, di: Direction, g: int, F, W):
        """A_d J for group g: F (faces..., T), W (cells..., nb, T) or None."""
        fax = di.axis
        n = F.shape[fax] - 1
        M1 = self.space.M1
        alpha = ((self.h[di.d] / 2) ** 2 / self.detJ / self.D[g])[..., None]  # (cells..., 1)
        m_t = di.m_t
        u = [F.take(np.arange(0, n), axis=fax), F.take(np.arange(1, n + 1), axis=fax)]
        if W is not None:
            u += [W[..., b, :] for b in range(W.shape[-2])]
        loc = [alpha * m_t * sum(M1[i, j] * u[j] for j in range(len(u))) for i in range(len(u))]
        AF = np.zeros_like(F)
        AF[_sl(F.ndim, fax, slice(0, n))] += loc[0]
        AF[_sl(F.ndim, fax, slice(1, n + 1))] += loc[1]
        # Marshak vacuum on both outer faces: 2 D 2^n_tr / face area, per mode m_t
        c = self._marshak(di, g)
        for e, f in ((0, 0), (n - 1, n)):
            AF[_sl(F.ndim, fax, slice(f, f + 1))] += m_t * c.take([e], axis=fax)[..., None] \
                * F.take([f], axis=fax)
        AW = np.stack(loc[2:], axis=-2) if W is not None else None
        return AF, AW

    def _marshak(self, di: Direction, g: int):
        """The vacuum coefficient 2 D 2^n_tr / face area of each cell (cells...)."""
        area = np.ones(self.D.shape[1:])
        for a in range(3):
            if a != di.d and (a == 0 or (a == 1 and self.space.dim >= 2)
                              or (a == 2 and self.space.dim == 3)):
                area = area * self.h[a]
        return 2.0 * self.D[g] * 2.0 ** di.n_tr / area

    def fick_solve(self, di: Direction, g: int, rF, rW):
        """J_d of group g with A_d J_d = (rF, rW), exact to float64 rounding:
        the bubbles condensed out element by element (A_d's element block is
        alpha m_t M1, so the condensation is M1's alone), then a tridiagonal
        solve along each line of faces, then the bubbles back.  rF (faces...,
        T), rW (cells..., nb, T) or None.  Returns (F, W)."""
        fax = di.axis
        M1 = self.space.M1
        nb = self.space.k
        s = ((self.h[di.d] / 2) ** 2 / self.detJ / self.D[g])[..., None] * di.m_t  # (cells..., T)
        if nb:
            Mbb_inv = np.linalg.inv(M1[2:, 2:])
            G = M1[:2, 2:] @ Mbb_inv  # (2, nb)
            Mc = M1[:2, :2] - G @ M1[2:, :2]
            cW = np.einsum("ib,...bt->i...t", G, rW)  # (2, cells..., T)
        else:
            Mc = M1[:2, :2]
            cW = np.zeros((2,) + s.shape)
        n = s.shape[fax]
        rhs = np.array(rF, dtype=np.float64)
        rhs[_sl(rhs.ndim, fax, slice(0, n))] -= cW[0]
        rhs[_sl(rhs.ndim, fax, slice(1, n + 1))] -= cW[1]
        diag = np.zeros_like(rhs)
        diag[_sl(rhs.ndim, fax, slice(0, n))] += s * Mc[0, 0]
        diag[_sl(rhs.ndim, fax, slice(1, n + 1))] += s * Mc[1, 1]
        c = self._marshak(di, g)[..., None] * di.m_t
        diag[_sl(rhs.ndim, fax, slice(0, 1))] += c.take([0], axis=fax)
        diag[_sl(rhs.ndim, fax, slice(n, n + 1))] += c.take([n - 1], axis=fax)
        off = np.moveaxis(s * Mc[0, 1], fax, 0)  # coupling of faces e and e + 1
        b, d = np.moveaxis(rhs, fax, 0).copy(), np.moveaxis(diag, fax, 0).copy()
        for e in range(1, n + 1):  # Thomas: eliminate below the diagonal
            m = off[e - 1] / d[e - 1]
            d[e] = d[e] - m * off[e - 1]
            b[e] = b[e] - m * b[e - 1]
        x = np.empty_like(b)
        x[n] = b[n] / d[n]
        for e in range(n - 1, -1, -1):
            x[e] = (b[e] - off[e] * x[e + 1]) / d[e]
        F = np.moveaxis(x, 0, fax)
        if not nb:
            return F, None
        uL, uR = F.take(np.arange(0, n), axis=fax), F.take(np.arange(1, n + 1), axis=fax)
        W = np.einsum("ab,...bt->...at", Mbb_inv, rW / s[..., None, :]) \
            - np.einsum("ab,b,...t->...at", Mbb_inv, M1[2:, 0], uL) \
            - np.einsum("ab,b,...t->...at", Mbb_inv, M1[2:, 1], uR)
        return F, W

    # -- the whole problem ----------------------------------------------------

    def jacobi(self, di: Direction, g: int):
        """This direction's part of the weights that equilibrate the balance,
        (cells..., P) for group g: each element's pairing rows squared over
        the face row sums of A (A applied to ones on the faces: the lumped
        face mass, with the Marshak term) and over A's bubble diagonal."""
        F = np.ones(self._face_shape(di) + (di.T,))
        AF, _ = self.A(di, g, F, None)
        fax = di.axis
        n = AF.shape[fax] - 1
        sq = di.BX ** 2  # (k + 2, P, T)
        est = (AF.take(np.arange(0, n), axis=fax) ** -1.0) @ sq[0].T \
            + (AF.take(np.arange(1, n + 1), axis=fax) ** -1.0) @ sq[1].T
        if self.space.k:
            alpha = ((self.h[di.d] / 2) ** 2 / self.detJ / self.D[g])[..., None]
            for b in range(self.space.k):
                abb = alpha * di.m_t * self.space.M1[2 + b, 2 + b]
                est = est + (1.0 / abb) @ sq[2 + b].T
        return est

    def _face_shape(self, di: Direction):
        shape = list(self.D.shape[1:])
        shape[di.axis] += 1
        return tuple(shape)

    def residuals(self, k: float, phi: np.ndarray, J: Dict) -> Dict[str, float]:
        sp = self.space
        w = sp.w_mode
        mass = self.detJ[..., None] * w  # (cells..., P)
        fiss = np.sum(self.nsf[..., None] * mass * phi, axis=0)  # (cells..., P)
        fick = 0.0
        bal = 0.0
        num_k = 0.0
        den_k = 0.0
        for g in range(self.ng):
            C = self.sigr[g][..., None] * mass
            lhs = C * phi[g]
            diag = C.copy()
            for di in sp.dirs:
                key = f"d{di.d}"
                F = J[key]["face"][g]
                W = J[key]["bub"][g] if sp.k else None
                rF, rW = self.BT(di, phi[g:g + 1])
                AF, AW = self.A(di, g, F, W)
                num = np.sum((AF - rF[0]) ** 2)
                den = np.sum(rF[0] ** 2)
                if W is not None:
                    num += np.sum((AW - rW[0]) ** 2)
                    den += np.sum(rW[0] ** 2)
                fick = max(fick, _ratio(num, den))
                lhs = lhs + self._B_group(di, F, W)
                diag = diag + self.jacobi(di, g)
            scat = sum(self.sigs[g, gp][..., None] * mass * phi[gp]
                       for gp in range(self.ng) if gp != g)
            fis = self.chi[g][..., None] * fiss
            src = fis / k + scat
            sdi = 1.0 / np.sqrt(diag)  # Jacobi equilibration, as the CG's norm
            bal = max(bal, _ratio(np.sum(((lhs - src) * sdi) ** 2), np.sum((src * sdi) ** 2)))
            num_k += float(np.sum(phi[g] * fis))
            den_k += float(np.sum(phi[g] * (lhs - scat)))
        k_rq = num_k / den_k if den_k > 0 else float("nan")
        k_gap = abs(k - k_rq) / k_rq if np.isfinite(k_rq) and k_rq > 0 else float("inf")
        return {"fick_res": fick, "balance_res": bal, "k_rq": k_rq,
                "k_gap": k_gap if np.isfinite(k_gap) else float("inf")}

    def _B_group(self, di: Direction, F, W):
        """B_d J of one group: F (faces..., T), W (cells..., nb, T) -> (cells..., P)."""
        fax = di.axis
        n = F.shape[fax] - 1
        out = (F.take(np.arange(0, n), axis=fax) @ di.BX[0].T
               + F.take(np.arange(1, n + 1), axis=fax) @ di.BX[1].T)
        if W is not None:
            out = out + np.einsum("...lt,lpt->...p", W, di.BX[2:])
        return out


def judge(ops: Operators, k: float, phi, J) -> Dict[str, float]:
    """The residuals of an answer (k, phi (ng, nz, ny, nx, P), J {"d<d>":
    {"face", "bub"}}) given in any float dtype, computed in float64."""
    phi = np.asarray(phi, dtype=np.float64)
    J = {key: {part: np.asarray(a, dtype=np.float64) for part, a in e.items()}
         for key, e in J.items()}
    return ops.residuals(float(k), phi, J)


def bfloat16_control(ops: Operators, phi) -> tuple:
    """The control in the program's place: the flux ``phi`` held in bfloat16,
    the current J = A_d^-1 B_d^T phi of that flux (``fick_solve``), and k the
    Rayleigh quotient of the two.  Returns (k, phi, J) in the public layout."""
    phi = round_to_bfloat16(phi)
    J = {}
    for di in ops.space.dirs:
        parts = [ops.fick_solve(di, g, *(a[0] if a is not None else None
                                         for a in ops.BT(di, phi[g:g + 1])))
                 for g in range(ops.ng)]
        J[f"d{di.d}"] = {"face": np.stack([F for F, _ in parts])}
        if ops.space.k:
            J[f"d{di.d}"]["bub"] = np.stack([W for _, W in parts])
    k = ops.residuals(1.0, phi, J)["k_rq"]
    return k, phi, J


def round_to_bfloat16(a: np.ndarray) -> np.ndarray:
    """float32 / float64 values rounded to the nearest bfloat16 (ties to even),
    returned as float64: what a bfloat16 store keeps of them."""
    bits = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)
