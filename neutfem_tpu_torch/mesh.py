"""Structured Cartesian mesh (host-side numpy), port of ``neutfem_tpu/mesh.py``.

A tensor-product mesh defined by breakpoints per axis, with dimensionality
auto-detected from the number of cells per axis (z>1 cells => 3D, y>1 => 2D,
else 1D), element numbering ``e = iz*nx*ny + iy*nx + ix`` and the reference's
boundary-attribute map.  Solver fields are ``(..., nz, ny, nx)`` grids.
Inactive ("fake") dimensions carry one cell of reference width ``h = 2`` so the
Piola scalings (``jac_d = h_d/2 = 1``) reduce exactly to the lower-dimensional
formulas.

The JAX package's ``best_axis_order`` (a TPU lane-padding heuristic) is not
ported: the port always solves in the user's axis order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["CartesianMesh", "boundary_attribute"]


def boundary_attribute(dim: int, axis: int, upper: bool) -> int:
    """Boundary attribute numbering of the reference (NeutFEM.cpp:2338-2347).

    1D: LEFT=1, RIGHT=2.
    2D: LEFT=1, RIGHT=2, TOP=3, BOTTOM=4.   (y axis: lower side = BOTTOM=4, upper = TOP=3)
    3D: BACK=1, FRONT=2, LEFT=3, RIGHT=4, TOP=5, BOTTOM=6.
    """
    if dim == 1:
        return 2 if upper else 1
    if dim == 2:
        if axis == 0:
            return 2 if upper else 1
        return 3 if upper else 4
    # 3D
    if axis == 2:  # z
        return 2 if upper else 1
    if axis == 0:  # x
        return 4 if upper else 3
    return 5 if upper else 6  # y


@dataclasses.dataclass(frozen=True)
class CartesianMesh:
    """Immutable mesh description (host-side metadata; arrays are numpy).

    Axis order for all solver grids is ``(nz, ny, nx)`` — x fastest.
    """

    dim: int
    nx: int
    ny: int
    nz: int
    # Cell widths per axis; inactive axes hold the single reference width 2.0.
    hx: np.ndarray
    hy: np.ndarray
    hz: np.ndarray
    x_breaks: np.ndarray
    y_breaks: np.ndarray
    z_breaks: np.ndarray

    @staticmethod
    def from_breaks(x_breaks, y_breaks=None, z_breaks=None) -> "CartesianMesh":
        xb = np.asarray(x_breaks, dtype=np.float64).ravel()
        yb = None if y_breaks is None else np.asarray(y_breaks, dtype=np.float64).ravel()
        zb = None if z_breaks is None else np.asarray(z_breaks, dtype=np.float64).ravel()
        if xb.size < 2:
            raise ValueError("x_breaks must contain at least 2 points")

        def ncells(b):
            return 0 if b is None else max(b.size - 1, 0)

        ny_c, nz_c = ncells(yb), ncells(zb)
        if nz_c >= 1 and ny_c >= 1:
            dim = 3
        elif ny_c >= 1:
            dim = 2
        else:
            dim = 1

        fake = np.array([2.0])
        hx = np.diff(xb)
        hy = np.diff(yb) if dim >= 2 else fake
        hz = np.diff(zb) if dim == 3 else fake
        if np.any(hx <= 0) or np.any(hy <= 0) or np.any(hz <= 0):
            raise ValueError("breakpoints must be strictly increasing")
        return CartesianMesh(
            dim=dim,
            nx=hx.size,
            ny=hy.size if dim >= 2 else 1,
            nz=hz.size if dim == 3 else 1,
            hx=hx,
            hy=hy if dim >= 2 else fake,
            hz=hz if dim == 3 else fake,
            x_breaks=xb,
            y_breaks=yb if yb is not None else np.array([-1.0, 1.0]),
            z_breaks=zb if zb is not None else np.array([-1.0, 1.0]),
        )

    # ---- derived geometry -------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Grid shape in solver axis order (nz, ny, nx)."""
        return (self.nz, self.ny, self.nx)

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny * self.nz

    def active(self, axis: int) -> bool:
        """Whether axis (0=x, 1=y, 2=z) is a true dimension of the problem."""
        return (axis == 0) or (axis == 1 and self.dim >= 2) or (axis == 2 and self.dim == 3)

    def h_grid(self, axis: int) -> np.ndarray:
        """Cell width along `axis`, broadcast to the full (nz, ny, nx) grid."""
        if axis == 0:
            return np.broadcast_to(self.hx[None, None, :], self.shape)
        if axis == 1:
            return np.broadcast_to(self.hy[None, :, None], self.shape)
        return np.broadcast_to(self.hz[:, None, None], self.shape)

    def volumes(self) -> np.ndarray:
        """True physical element volumes (product over *active* axes), (nz, ny, nx)."""
        v = self.h_grid(0).copy()
        if self.dim >= 2:
            v = v * self.h_grid(1)
        if self.dim == 3:
            v = v * self.h_grid(2)
        return v

    def det_jac(self) -> np.ndarray:
        """detJ = prod_d (h_d / 2) including fake axes (jac=1 there), (nz, ny, nx)."""
        return self.h_grid(0) / 2.0 * (self.h_grid(1) / 2.0) * (self.h_grid(2) / 2.0)

    def centers(self, axis: int) -> np.ndarray:
        b = (self.x_breaks, self.y_breaks, self.z_breaks)[axis]
        return 0.5 * (b[:-1] + b[1:])

    def boundary_attrs(self):
        """Map axis -> (attr_lower, attr_upper) for the active axes."""
        out = {}
        for ax in range(3):
            if self.active(ax):
                out[ax] = (
                    boundary_attribute(self.dim, ax, upper=False),
                    boundary_attribute(self.dim, ax, upper=True),
                )
        return out
