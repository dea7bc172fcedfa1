"""Reference-compatible ``NeutFEM`` facade on the PyTorch solver layers.

Port of the subset of ``neutfem/_neutfem_eigen.py`` that the benchmark runner
and ``bench.py`` use: construction, the cross-section views, boundary
conditions, solver settings, ``BuildMatrices``, ``SolveKeff`` (with the
coarse-grid initialization and CMFD), ``SolveAdjoint``, ``SolveCoarse`` and
the explicit-Schur DIRECT_* solver types.  The facade takes its device
explicitly (``device=``) and never picks one.  Axis order is the user's (the
JAX facade's TPU lane-padding relabel is not ported).

The DIRECT_* solver types run the dense equilibrated Cholesky of
``ops/direct.py``, gated, as in the JAX facade, to n_phi <=
``NEUTFEM_DIRECT_MAX_NPHI`` (default 4096): above the gate the solve warns
(``RuntimeWarning``) and runs the equilibrated CG — the facade's documented
behaviour (``neutfem/_neutfem_eigen.py:418-443``), not a device fallback.

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
from .coarse import coarse_init
from .fespace import make_fespace
from .mesh import CartesianMesh
from .ops.context import build_context
from .ops.direct import DIRECT_MAX_NPHI, attach_dense_schur
from .power import SolveOptions, biorthogonal_inner, power_iteration, resolve_precond
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


_SOLVER_NAMES = {
    LinearSolverType.DIRECT_LU: "SparseLU",
    LinearSolverType.DIRECT_LDLT: "SimplicialLDLT",
    LinearSolverType.DIRECT_LLT: "SimplicialLLT",
    LinearSolverType.CG: "ConjugateGradient",
    LinearSolverType.CG_DIAG: "ConjugateGradient+Diagonal",
    LinearSolverType.CG_ICHOL: "ConjugateGradient+IncompleteCholesky",
    LinearSolverType.BICGSTAB: "BiCGSTAB",
    LinearSolverType.BICGSTAB_DIAG: "BiCGSTAB+Diagonal",
    LinearSolverType.BICGSTAB_ILU: "BiCGSTAB+ILUT",
    LinearSolverType.LCG: "LeastSquaresConjugateGradient",
}

# Every iterative variant maps onto the equilibrated Schur CG (the Schur
# complement is SPD), the DIRECT_* variants onto the dense equilibrated
# Cholesky, as in the JAX facade.
_DIRECT = (LinearSolverType.DIRECT_LU, LinearSolverType.DIRECT_LDLT,
           LinearSolverType.DIRECT_LLT)


def _check_health(keff: float, finite, what: str):
    """Warn (``RuntimeWarning``) on a non-finite result, or on a finite k
    outside [0.5, 2.0], which no reactor-physics problem gives (the JAX
    facade's ``_check_health``)."""
    if not (finite and np.isfinite(keff)):
        warnings.warn(f"{what} produced non-finite results (keff={keff})",
                      RuntimeWarning, stacklevel=3)
    elif keff < 0.5 or keff > 2.0:
        warnings.warn(f"{what} converged to an implausible eigenvalue keff={keff:.6g} "
                      "(outside [0.5, 2.0]); check cross-sections, boundary conditions "
                      "and solver flags", RuntimeWarning, stacklevel=3)


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

        self._cmfd_omega = 1.0
        self._ctx = None
        self.build_seconds: Dict[str, float] = {}  # last BuildMatrices: context, twogrid
        self._phi: Optional[torch.Tensor] = None  # (ng, nz, ny, nx, P)
        self._phi_adj: Optional[torch.Tensor] = None
        self._J = None
        self._J_adj = None
        self._keff: Optional[float] = None
        self._keff_adj: Optional[float] = None
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

    def set_cmfd_relaxation(self, omega: float):
        self._cmfd_omega = float(omega)

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

    def get_flux_adj(self) -> np.ndarray:
        """The P_0 (cell-average) adjoint flux (ng[,nz][,ny],nx) of the last
        SolveAdjoint, zeros before one."""
        if self._phi_adj is None:
            return self._squeeze(np.zeros((self._ng, *self._mesh.shape)))
        return self._squeeze(self._phi_adj[..., 0].cpu().numpy())

    def GetNumElements(self) -> int:
        return self._mesh.n_elements

    def GetLastKeffAdjoint(self) -> float:
        return self._keff_adj if self._keff_adj is not None else 0.0

    def GetSolverName(self) -> str:
        return _SOLVER_NAMES[self._solver_type]

    def reset_flux(self):
        self._phi = None
        self._phi_adj = None
        self._J = None
        self._J_adj = None
        self._keff = None
        self._keff_adj = None

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

    def _inner_solver(self) -> str:
        """The inner solver of the next solve: "direct" for the DIRECT_* types up
        to the dense gate (n_phi <= NEUTFEM_DIRECT_MAX_NPHI), else "cg" — above
        the gate with the JAX facade's loud warning.  Attaches the dense factors
        to the context when they are needed and missing."""
        if self._solver_type not in _DIRECT:
            return "cg"
        gate = int(os.environ.get("NEUTFEM_DIRECT_MAX_NPHI", DIRECT_MAX_NPHI))
        if self._fes.n_phi > gate:
            warnings.warn(
                f"{_SOLVER_NAMES[self._solver_type]}: dense explicit-Schur is gated to "
                f"n_phi <= {gate} (have {self._fes.n_phi}); falling back to the "
                "equilibrated Schur-CG (raise NEUTFEM_DIRECT_MAX_NPHI to override)",
                RuntimeWarning, stacklevel=3)
            return "cg"
        if "schur_chol" not in self._ctx:
            self._log(VerbosityLevel.VERBOSE,
                      f"Building explicit Schur factors (n_phi={self._fes.n_phi})")
            attach_dense_schur(self._fes, self._ctx, "exact")
        return "direct"

    def _opts(self, inner_solver: str = "cg", use_cmfd: bool = False) -> SolveOptions:
        return SolveOptions(
            tol_keff=self._tol_keff,
            tol_flux=self._tol_flux,
            # the reference wires tol_flux (not tol_L2) into the Schur solver
            # (NeutFEM.cpp:334)
            inner_tol=self._tol_flux,
            max_outer=self._max_outer,
            max_inner=self._max_inner,
            # adaptive inner tolerance (default on at 0.03, as in the JAX facade);
            # NEUTFEM_INNER_ETA=0 restores the reference's fixed tolerance
            inner_eta=float(os.environ.get("NEUTFEM_INNER_ETA", "0.03")),
            inner_solver=inner_solver,
            use_cmfd=use_cmfd,
            cmfd_omega=self._cmfd_omega,
            inner_precond=os.environ.get("NEUTFEM_PRECOND", "auto"),
            tg_degree=int(os.environ.get("NEUTFEM_TG_DEGREE", "8")),
            tg_kappa=float(os.environ.get("NEUTFEM_TG_KAPPA", "30.0")),
        )

    def preconditioner(self) -> str:
        """The preconditioner the group solves run (the "auto" rule resolved)."""
        if self._ctx is None:
            raise RuntimeError("BuildMatrices() must be called first")
        return resolve_precond(self._fes, self._ctx, self._opts().inner_precond)

    def _flat_phi(self):
        return torch.ones((self._ng, *self._mesh.shape, self._fes.P),
                          dtype=self._dtype, device=self._device)

    def _coarse(self, factors: Sequence[int]):
        """coarse_init at (x, y, z) factors (missing ones 1): (k, fine phi0)."""
        f = tuple(int(v) for v in factors) + (1,) * max(0, 3 - len(factors))
        k_c, phi0 = coarse_init(self._fes, self._ng, self._xs, self._bcs, f[:3], self._opts(),
                                self._device, self._dtype, marshak_d_factor=True)
        return float(k_c), phi0

    def _solve(self, opts: SolveOptions, phi0, keff0, adjoint: bool = False,
               fixed_keff=None):
        """One power iteration; returns (result, host [k, dk, dphi, finite])."""
        res = power_iteration(self._fes, self._ng, opts, self._ctx, phi0, keff0,
                              adjoint=adjoint, fixed_keff=fixed_keff)
        host = torch.stack([res["keff"], res["diff_k"], res["diff_flux"],
                            res["finite"].to(self._dtype)]).tolist()
        self._last_history = res["history"].cpu().numpy()
        return res, host

    def SolveKeff(self, use_coarse_init: bool = False, coarse_factors: Sequence[int] = (),
                  use_diagonal_solver: bool = False, use_cmfd: bool = False) -> float:
        if use_diagonal_solver:
            raise NotImplementedError("the diagonal solver (a_mode 'diag') is not ported")
        if self._ctx is None:
            raise RuntimeError("BuildMatrices() must be called before solving")
        opts = self._opts(self._inner_solver(), use_cmfd=use_cmfd)
        keff0 = self._keff if self._keff else 1.0
        phi0 = self._phi if self._phi is not None else self._flat_phi()
        if use_coarse_init and len(coarse_factors) > 0:
            keff0, phi0 = self._coarse(coarse_factors)
            self._log(VerbosityLevel.NORMAL, f"  coarse init: k-eff = {keff0:.6f}")

        t0 = time.time()
        res, (keff, dk, dphi, finite) = self._solve(opts, phi0, keff0)
        self._phi = res["phi"]
        self._J = res["J"]
        self._keff = keff
        self._last_outers = res["outer_iterations"]
        self._last_inners = res["inner_iterations"]
        _check_health(keff, finite, "SolveKeff")
        self._log(
            VerbosityLevel.NORMAL,
            f"SolveKeff: k-eff = {keff:.6f} in {self._last_outers} outer / "
            f"{self._last_inners} inner iterations "
            f"({time.time() - t0:.3f}s, dk={dk:.2e}, dphi={dphi:.2e})",
        )
        return keff

    def SolveAdjoint(self, normalize_to_direct: bool = True,
                     use_direct_keff: bool = True) -> float:
        """The adjoint eigenproblem (NeutFEM.cpp:1877-2082): at the direct
        solve's k when ``use_direct_keff`` and one exists, else free-running;
        with ``normalize_to_direct`` the adjoint flux is scaled to
        <phi, phi_adj>_M = 1 (NeutFEM.cpp:2020-2066).  The outer count is
        ``len(get_iteration_history())``, as in the JAX facade."""
        if self._ctx is None:
            raise RuntimeError("BuildMatrices() must be called before solving")
        opts = self._opts(self._inner_solver())
        fixed = self._keff if (use_direct_keff and self._keff) else None
        keff0 = fixed if fixed is not None else (self._keff or 1.0)
        phi0 = self._phi_adj if self._phi_adj is not None else self._flat_phi()

        t0 = time.time()
        res, (keff, _, _, finite) = self._solve(opts, phi0, keff0, adjoint=True,
                                                fixed_keff=fixed)
        keff_adj = keff if fixed is None else float(fixed)
        phi_adj = res["phi"]
        if normalize_to_direct and self._phi is not None:
            ip = biorthogonal_inner(self._ctx, self._phi, phi_adj)
            if abs(float(ip)) > 1e-14:
                phi_adj = phi_adj / ip
        self._phi_adj = phi_adj
        self._J_adj = res["J"]
        self._keff_adj = keff_adj
        _check_health(keff_adj, finite, "SolveAdjoint")
        self._log(VerbosityLevel.NORMAL,
                  f"SolveAdjoint: k-eff(adj) = {keff_adj:.6f} in "
                  f"{res['outer_iterations']} outers ({time.time() - t0:.3f}s)")
        return keff_adj

    def SolveCoarse(self, refine: Sequence[int]):
        """Coarse solve + P_0 injection (NeutFEM.cpp:2380-2611): sets the flux and
        k that the next SolveKeff starts from; returns (k, fine P_0 flux
        (ng, nz, ny, nx) as numpy)."""
        k_c, phi0 = self._coarse(refine)
        self._phi = phi0
        self._keff = k_c
        return k_c, phi0[..., 0].cpu().numpy()
