"""Reference-compatible ``NeutFEM`` facade on the PyTorch solver layers.

Port of the subset of ``neutfem/_neutfem_eigen.py`` that the benchmark runner
and ``bench.py`` use: construction, the cross-section views, boundary
conditions, solver settings, ``BuildMatrices`` and ``SolveKeff``.  The facade
takes its device explicitly (``device=``) and never picks one.  Axis order is
the user's (the JAX facade's TPU lane-padding relabel is not ported).

The Marshak (DIRICHLET) boundary term uses the reference's ``2*D*G_ff``
convention (NeutFEM.cpp:1350, ``marshak_d_factor=True``) for eigenvalue parity.

``BuildMatrices`` also attaches the two-grid coarse level where the JAX facade
does (``neutfem/_neutfem_eigen.py:388-409``), outside any solve.  The same
environment variables as there select the preconditioner:

* ``NEUTFEM_PRECOND`` (default "auto"): the group solves' ``inner_precond``;
  "twogrid" attaches the coarse level, and "auto" attaches it on 2D meshes of
  65,536 cells or more at P == 1 (``twogrid.auto_twogrid``);
* ``NEUTFEM_TG_MODE`` ("dense" | "cheby", default "dense") and
  ``NEUTFEM_TG_DENSE_MAX`` (default 8192): the coarse inverse's form and cap;
* ``NEUTFEM_TG_DEGREE`` (8) and ``NEUTFEM_TG_KAPPA`` (30.0): the Chebyshev
  form's degree and interval.
"""

from __future__ import annotations

import enum
import os
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import config
from .bc import BCKind, BCSpec
from .fespace import make_fespace
from .mesh import CartesianMesh
from .ops.context import build_context
from .power import SolveOptions, power_iteration, resolve_precond
from .twogrid import DENSE_MAX_NC, attach_twogrid, auto_twogrid

__all__ = ["NeutFEM", "BCType", "LinearSolverType", "VerbosityLevel"]


class BCType(enum.IntEnum):
    DIRICHLET = 0
    NEUMANN = 1
    MIRROR = 2
    ROBIN = 3
    PERIODIC = 4


class VerbosityLevel(enum.IntEnum):
    SILENT = 0
    LIGHT = 1
    NORMAL = 2
    VERBOSE = 3
    DEBUG = 4


class LinearSolverType(enum.IntEnum):
    DIRECT_LU = 0
    DIRECT_LDLT = 1
    DIRECT_LLT = 2
    CG = 3
    CG_DIAG = 4
    CG_ICHOL = 5
    BICGSTAB = 6
    BICGSTAB_DIAG = 7
    BICGSTAB_ILU = 8
    LCG = 9


# Every iterative variant maps onto the equilibrated Schur CG (the Schur
# complement is SPD), as in the JAX facade; the explicit-Schur direct path is
# not ported.
_DIRECT = (LinearSolverType.DIRECT_LU, LinearSolverType.DIRECT_LDLT,
           LinearSolverType.DIRECT_LLT)

#: Adaptive inner-tolerance factor of the JAX facade's default (NEUTFEM_INNER_ETA).
INNER_ETA = 0.03


class NeutFEM:
    """Reference-compatible solver facade (the subset the benchmarks use)."""

    def __init__(self, *args, device, dtype=None):
        if len(args) == 5:
            rt_order, ng, xb, yb, zb = args
            p_order = rt_order
        elif len(args) == 6:
            rt_order, p_order, ng, xb, yb, zb = args
        else:
            raise TypeError(
                "NeutFEM(order, ng, x_breaks, y_breaks, z_breaks, device=...) or "
                "NeutFEM(rt_order, p_order, ng, x_breaks, y_breaks, z_breaks, device=...)"
            )
        rt_order, p_order, ng = int(rt_order), int(p_order), int(ng)
        if p_order > rt_order:
            p_order = rt_order  # inf-sup guard (NeutFEM.cpp:149-169)
        self._device = torch.device(device)
        self._dtype = config.real_dtype if dtype is None else dtype
        self._mesh = CartesianMesh.from_breaks(xb, yb, zb)
        self._fes = make_fespace(self._mesh, rt_order, p_order)
        self._ng = ng

        sh = (ng, *self._mesh.shape)
        # XS storage with the reference defaults (NeutFEM.cpp:179-218)
        self._xs: Dict[str, np.ndarray] = {
            "D": np.full(sh, 1.0),
            "SRC": np.zeros(sh),
            "SigR": np.full(sh, 0.01),
            "NSF": np.zeros(sh),
            "KSF": np.zeros(sh),
            "Chi": np.zeros(sh),
            "SigS": np.zeros((ng, ng, *self._mesh.shape)),
        }
        self._xs["Chi"][0] = 1.0

        self._bcs = BCSpec()
        self._solver_type = LinearSolverType.BICGSTAB  # reference default
        self._tol_keff = 1e-5
        self._tol_flux = 1e-5
        self._max_outer = 200
        self._max_inner = 1000
        self._verbosity = VerbosityLevel.NORMAL

        self._ctx = None
        self.build_seconds: Dict[str, float] = {}  # last BuildMatrices: context, twogrid
        self._phi: Optional[torch.Tensor] = None  # (ng, nz, ny, nx, P)
        self._J = None
        self._keff: Optional[float] = None
        self._last_outers = 0
        self._last_inners = 0
        self._last_history = np.zeros((0, 4))

        self._log(
            VerbosityLevel.NORMAL,
            f"NeutFEM RT{rt_order}-P{p_order}: {self._mesh.dim}D mesh "
            f"{self._mesh.nx}x{self._mesh.ny}x{self._mesh.nz}, {ng} groups, "
            f"{self._fes.n_phi} flux DOFs [torch {self._device}, {self._dtype}]",
        )

    def _log(self, level: VerbosityLevel, *msg):
        if self._verbosity >= level:
            print(*msg)

    def _squeeze(self, arr: np.ndarray) -> np.ndarray:
        """The dimension-appropriate mutable view (ng[,nz][,ny],nx)."""
        if self._mesh.dim == 3:
            return arr
        if self._mesh.dim == 2:
            return arr[..., 0, :, :]
        return arr[..., 0, 0, :]

    # -- configuration --------------------------------------------------------

    def set_bc(self, attr: int, bc_type, value: float = 0.0):
        self._bcs.set(int(attr), BCKind(int(bc_type)), float(value))
        self._ctx = None

    def set_linear_solver(self, solver_type):
        self._solver_type = LinearSolverType(int(solver_type))

    def set_tol(self, tol_keff=1e-5, tol_flux=1e-5, tol_L2=1e-5, max_outer=200,
                max_inner=1000):
        """tol_L2 is accepted for the reference signature and unused, as in the
        reference (the Schur solver takes tol_flux, NeutFEM.cpp:334)."""
        self._tol_keff = float(tol_keff)
        self._tol_flux = float(tol_flux)
        self._max_outer = int(max_outer)
        self._max_inner = int(max_inner)

    def set_verbosity(self, level):
        self._verbosity = VerbosityLevel(int(level))

    # -- data access ----------------------------------------------------------

    def get_D(self):
        return self._squeeze(self._xs["D"])

    def get_SigR(self):
        return self._squeeze(self._xs["SigR"])

    def get_NSF(self):
        return self._squeeze(self._xs["NSF"])

    def get_KSF(self):
        return self._squeeze(self._xs["KSF"])

    def get_Chi(self):
        return self._squeeze(self._xs["Chi"])

    def get_SigS(self):
        return self._squeeze(self._xs["SigS"])

    def get_iteration_history(self) -> np.ndarray:
        """(n_outer, 4) per-outer [k, dk, dphi, inner iters] of the last SolveKeff."""
        return self._last_history

    def GetNumElements(self) -> int:
        return self._mesh.n_elements

    def reset_flux(self):
        self._phi = None
        self._J = None
        self._keff = None

    # -- assembly and solve ---------------------------------------------------

    def BuildMatrices(self):
        """Stage geometry + XS to the device operator context, with the two-grid
        coarse level where NEUTFEM_PRECOND asks for it (module docstring)."""
        t0 = time.perf_counter()
        self._ctx = build_context(self._fes, self._ng, self._xs, self._bcs,
                                  device=self._device, dtype=self._dtype,
                                  marshak_d_factor=True)
        self.build_seconds = {"context": time.perf_counter() - t0}
        self._log(VerbosityLevel.NORMAL,
                  f"BuildMatrices: operator context staged in {self.build_seconds['context']:.3f}s")
        precond = os.environ.get("NEUTFEM_PRECOND", "auto")
        want_tg = precond == "twogrid" or (precond == "auto" and self._fes.P == 1
                                           and auto_twogrid(self._mesh))
        if want_tg:
            t0 = time.perf_counter()
            attach_twogrid(self._fes, self._ng, self._xs, self._bcs, self._ctx,
                           marshak_d_factor=True,
                           mode=os.environ.get("NEUTFEM_TG_MODE", "dense"),
                           dense_max=int(os.environ.get("NEUTFEM_TG_DENSE_MAX", DENSE_MAX_NC)))
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            dt = self.build_seconds["twogrid"] = time.perf_counter() - t0
            self._log(VerbosityLevel.NORMAL, f"BuildMatrices: two-grid coarse level in {dt:.3f}s")

    def _opts(self) -> SolveOptions:
        return SolveOptions(
            tol_keff=self._tol_keff,
            tol_flux=self._tol_flux,
            # the reference wires tol_flux (not tol_L2) into the Schur solver
            # (NeutFEM.cpp:334)
            inner_tol=self._tol_flux,
            max_outer=self._max_outer,
            max_inner=self._max_inner,
            inner_eta=INNER_ETA,
            inner_precond=os.environ.get("NEUTFEM_PRECOND", "auto"),
            tg_degree=int(os.environ.get("NEUTFEM_TG_DEGREE", "8")),
            tg_kappa=float(os.environ.get("NEUTFEM_TG_KAPPA", "30.0")),
        )

    def preconditioner(self) -> str:
        """The preconditioner the group solves run (the "auto" rule resolved)."""
        if self._ctx is None:
            raise RuntimeError("BuildMatrices() must be called first")
        return resolve_precond(self._fes, self._ctx, self._opts().inner_precond)

    def SolveKeff(self, use_coarse_init: bool = False, coarse_factors: Sequence[int] = (),
                  use_diagonal_solver: bool = False, use_cmfd: bool = False) -> float:
        if use_coarse_init or use_diagonal_solver or use_cmfd:
            raise NotImplementedError(
                "coarse init, the diagonal solver and CMFD are not ported")
        if self._solver_type in _DIRECT:
            raise NotImplementedError("the explicit-Schur direct solvers are not ported")
        if self._ctx is None:
            raise RuntimeError("BuildMatrices() must be called before solving")
        opts = self._opts()
        keff0 = self._keff if self._keff else 1.0
        phi0 = self._phi
        if phi0 is None:
            phi0 = torch.ones((self._ng, *self._mesh.shape, self._fes.P),
                              dtype=self._dtype, device=self._device)

        t0 = time.time()
        res = power_iteration(self._fes, self._ng, opts, self._ctx, phi0, keff0)
        host = torch.stack([res["keff"], res["diff_k"], res["diff_flux"],
                            res["finite"].to(self._dtype)]).tolist()
        keff, dk, dphi, finite = host
        self._phi = res["phi"]
        self._J = res["J"]
        self._keff = keff
        self._last_outers = res["outer_iterations"]
        self._last_inners = res["inner_iterations"]
        self._last_history = res["history"].cpu().numpy()
        if not (finite and np.isfinite(keff)):
            warnings.warn(f"SolveKeff produced non-finite results (keff={keff})",
                          RuntimeWarning, stacklevel=2)
        self._log(
            VerbosityLevel.NORMAL,
            f"SolveKeff: k-eff = {keff:.6f} in {self._last_outers} outer / "
            f"{self._last_inners} inner iterations "
            f"({time.time() - t0:.3f}s, dk={dk:.2e}, dphi={dphi:.2e})",
        )
        return keff
