"""Reference-compatible ``NeutFEM`` facade on the PyTorch solver layers.

Port of ``neutfem/_neutfem_eigen.py``: construction (positional or by
keyword), the cross-section views and getters, boundary conditions (with the
symmetry helpers and the Robin coefficients), solver settings and the
accelerator choice, ``BuildMatrices``, ``SolveKeff`` (with the coarse-grid
initialization and CMFD), ``SolveAdjoint``, ``SolveSubcritical``,
``SolveCoarse``, the explicit-Schur DIRECT_* solver types, the flux
projections and the zoom, checkpoints and the VTK export.  Not ported: the
diagonal A-solve (``use_diagonal_solver``, ``build_diagonal_cache`` at
RT0-P0), PERIODIC and nonzero NEUMANN boundaries.

The facade runs on the card (``device="cuda"``, the default) unless it is
given ``device="cpu"``; without a CUDA device it raises and never falls back
to the CPU.  Axis order is the user's (the JAX facade's TPU lane-padding
relabel is not ported, so checkpoints record ``axperm`` (0, 1, 2)).

The operator context is built by ``BuildMatrices`` and rebuilt lazily, at the
next solve, after anything that changes the boundaries (``set_bc``,
``set_robin_coefficients``, the symmetry helpers), as the JAX facade's
context cache is; the old context's CG plans go with it.

The DIRECT_* solver types run the dense equilibrated Cholesky of
``ops/direct.py``, gated, as in the JAX facade, to n_phi <=
``NEUTFEM_DIRECT_MAX_NPHI`` (default 4096): above the gate the solve warns
(``RuntimeWarning``) and runs the equilibrated CG — the facade's documented
behaviour (``neutfem/_neutfem_eigen.py:418-443``), not a device fallback.

The Marshak (DIRICHLET) boundary term uses the reference's ``2*D*G_ff``
convention (NeutFEM.cpp:1350, ``marshak_d_factor=True``) for eigenvalue parity.

The context build also attaches the two-grid coarse level where the JAX
facade does (``neutfem/_neutfem_eigen.py:388-409``), outside any solve.  The
same environment variables as there select the preconditioner:

* ``NEUTFEM_PRECOND`` (default "auto"): the group solves' ``inner_precond``;
  "twogrid" attaches the coarse level, and "auto" attaches it on 2D meshes of
  65,536 cells or more at P == 1 (``twogrid.auto_twogrid``);
* ``NEUTFEM_TG_MODE`` ("dense" | "cheby", default "dense") and
  ``NEUTFEM_TG_DENSE_MAX`` (default 8192): the coarse inverse's form and cap;
* ``NEUTFEM_TG_DEGREE`` (8) and ``NEUTFEM_TG_KAPPA`` (30.0): the Chebyshev
  form's degree and interval.

``NEUTFEM_PROFILE=<dir>`` writes a ``torch.profiler`` trace of each
``SolveKeff`` into ``<dir>`` (the JAX facade's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import enum
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import config
from .bc import BCKind, BCSpec
from .coarse import coarse_init
from .elements import legendre_table
from .fespace import make_fespace
from .krylov import drop_plans
from .mesh import CartesianMesh
from .ops.context import build_context
from .ops.direct import DIRECT_MAX_NPHI, attach_dense_schur
from .power import (SolveOptions, biorthogonal_inner, fixed_source_solve, power_iteration,
                    resolve_precond, solve_subcritical)
from .twogrid import DENSE_MAX_NC, attach_twogrid, auto_twogrid
from .vtk import write_vtk

__all__ = ["NeutFEM", "BCType", "BoundaryID", "LinearSolverType", "VerbosityLevel"]


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


class BoundaryID(enum.IntEnum):
    # aliased values exactly as the reference header (NeutFEM.hpp:73-91)
    LEFT_1D = 1
    RIGHT_1D = 2
    LEFT_2D = 1
    RIGHT_2D = 2
    TOP_2D = 3
    BOTTOM_2D = 4
    BACK_3D = 1
    FRONT_3D = 2
    LEFT_3D = 3
    RIGHT_3D = 4
    TOP_3D = 5
    BOTTOM_3D = 6


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


def _subcell_average_matrix(order: int, r: int) -> np.ndarray:
    """T[s, n] = average of Legendre P_n over subcell s of [-1, 1] split into r
    parts, via the antiderivative identity (2n+1) int P_n = P_{n+1} - P_{n-1}."""
    edges = np.linspace(-1.0, 1.0, r + 1)
    Pe = legendre_table(order + 1, edges)  # (order+2, r+1)
    T = np.zeros((r, order + 1))
    width = 2.0 / r
    for n in range(order + 1):
        prim = edges.copy() if n == 0 else (Pe[n + 1] - Pe[n - 1]) / (2 * n + 1)
        T[:, n] = (prim[1:] - prim[:-1]) / width
    return T


def _device_of(device) -> torch.device:
    """The facade's device: the card unless the caller asks for another; a
    CUDA device without CUDA raises (the facade never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("NeutFEM: no CUDA device available (pass device='cpu' to run on "
                           "the CPU)")
    return device


class NeutFEM:
    """Reference-compatible solver facade (wrapper.cpp:274-1065)."""

    _POSITIONAL = (("order", "ng", "x_breaks", "y_breaks", "z_breaks"),
                   ("rt_order", "p_order", "ng", "x_breaks", "y_breaks", "z_breaks"))

    def __init__(self, *args, device="cuda", dtype=None, **kwargs):
        # Both pybind overloads, positionally or by keyword (the README's quick
        # start calls NeutFEM(order=0, ng=2, x_breaks=..., y_breaks=..., z_breaks=...))
        if kwargs:
            five = "order" in kwargs or len(args) + len(kwargs) == 5
            names = self._POSITIONAL[0 if five else 1]
            vals = dict(zip(names, args))
            vals.update(kwargs)
            missing = [n for n in names if n not in vals]
            unknown = [n for n in vals if n not in names]
            if missing or unknown:
                raise TypeError(f"NeutFEM: missing arguments {missing}, unknown {unknown}")
            args = tuple(vals[n] for n in names)
        if len(args) == 5:
            rt_order, ng, xb, yb, zb = args
            p_order = rt_order
        elif len(args) == 6:
            rt_order, p_order, ng, xb, yb, zb = args
        else:
            raise TypeError(
                "NeutFEM(order, ng, x_breaks, y_breaks, z_breaks) or "
                "NeutFEM(rt_order, p_order, ng, x_breaks, y_breaks, z_breaks)"
            )
        rt_order, p_order, ng = int(rt_order), int(p_order), int(ng)
        if p_order > rt_order:
            p_order = rt_order  # inf-sup guard (NeutFEM.cpp:149-169)
        self._device = _device_of(device)
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
        self._accel = "chebyshev"  # reference hardwires Chebyshev (NeutFEM.cpp:1673)
        self._sym_flags: List[str] = []
        self._built = False
        self._ctx = None  # the operator context; None until built, or stale
        self.build_seconds: Dict[str, float] = {}  # last context build: context, twogrid
        self._phi: Optional[torch.Tensor] = None  # (ng, nz, ny, nx, P)
        self._phi_adj: Optional[torch.Tensor] = None
        self._J = None
        self._J_adj = None
        self._keff: Optional[float] = None
        self._keff_adj: Optional[float] = None
        self._last_outers = 0
        self._last_inners = 0
        self._last_schur_iterations = 0
        self._last_schur_residual = 0.0
        self._last_history = np.zeros((0, 4))
        self.subcritical_outers = (0, 0)  # last SolveSubcritical: with, without fission

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

    def _stale(self):
        """The boundaries changed: the next solve rebuilds the context.  The
        old context's CG plans are dropped now (a plan outliving its context
        would hold its graph and operands)."""
        if self._ctx is not None:
            drop_plans(self._ctx)
        self._ctx = None

    def set_bc(self, attr: int, bc_type, value: float = 0.0):
        self._bcs.set(int(attr), BCKind(int(bc_type)), float(value))
        self._stale()

    def set_robin_coefficients(self, alpha: float, beta: float):
        self._bcs.robin_alpha = float(alpha)
        self._bcs.robin_beta = float(beta)
        self._stale()

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

    def set_acceleration(self, kind: str):
        """The outer-iteration accelerator: "chebyshev" (the reference's
        hardwired choice), "anderson" or "none"."""
        kind = str(kind).lower()
        if kind not in ("chebyshev", "anderson", "none"):
            raise ValueError(f"unknown acceleration {kind!r}")
        self._accel = kind

    def apply_quarter_symmetry(self, axis1: int = 0, axis2: int = 1):
        """Reference behaviour (NeutFEM.cpp:356-362): MIRROR on the two cut
        planes of a quarter core, and the flag recorded (drivers then set
        their boundaries explicitly)."""
        self._bcs.set(int(BoundaryID.LEFT_2D), BCKind.MIRROR)
        self._bcs.set(int(BoundaryID.BOTTOM_2D), BCKind.MIRROR)
        self._sym_flags.append(f"quarter({axis1},{axis2})")
        self._stale()

    # Names every reference benchmark driver calls but the reference wrapper
    # does not bind (wrapper.cpp:518)
    def apply_quarter_rotational_symmetry(self, axis1: int = 0, axis2: int = 1):
        self.apply_quarter_symmetry(axis1, axis2)

    def apply_central_symmetry(self, axis1: int = 0, axis2: int = 1):
        self._sym_flags.append(f"central({axis1},{axis2})")

    # Reflector API: no-ops, as in the reference (NeutFEM.cpp:2614-2620)
    def add_refl(self, *args, **kwargs):
        return None

    def set_refl(self, *args, **kwargs):
        return None

    def clean_refl(self, *args, **kwargs):
        return None

    # -- data access ----------------------------------------------------------

    def get_D(self):
        return self._squeeze(self._xs["D"])

    def get_SRC(self):
        return self._squeeze(self._xs["SRC"])

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

    def get_flux_full(self) -> Optional[np.ndarray]:
        """The P_0 (cell-average) flux (ng, nz, ny, nx) of the last solve, or None."""
        return None if self._phi is None else self._phi[..., 0].cpu().numpy()

    def get_flux_adj_full(self) -> Optional[np.ndarray]:
        return None if self._phi_adj is None else self._phi_adj[..., 0].cpu().numpy()

    def get_flux(self) -> np.ndarray:
        """The P_0 flux (ng[,nz][,ny],nx) of the last solve, zeros before one."""
        full = self.get_flux_full()
        return self._squeeze(np.zeros((self._ng, *self._mesh.shape)) if full is None else full)

    def get_flux_adj(self) -> np.ndarray:
        """The P_0 adjoint flux (ng[,nz][,ny],nx) of the last SolveAdjoint,
        zeros before one."""
        full = self.get_flux_adj_full()
        return self._squeeze(np.zeros((self._ng, *self._mesh.shape)) if full is None else full)

    def GetNumElements(self) -> int:
        return self._mesh.n_elements

    def GetNumGroups(self) -> int:
        return self._ng

    def GetDimension(self) -> int:
        return self._mesh.dim

    def GetLastKeff(self) -> float:
        return self._keff if self._keff is not None else 0.0

    def GetLastKeffAdjoint(self) -> float:
        return self._keff_adj if self._keff_adj is not None else 0.0

    def GetSolverName(self) -> str:
        return _SOLVER_NAMES[self._solver_type]

    # The reference's SchurSolver diagnostics (solvers.hpp:358-366): the
    # Krylov count and residual of the last group solve of the last solve
    def GetLastIterations(self) -> int:
        return self._last_schur_iterations

    def GetLastResidual(self) -> float:
        return self._last_schur_residual

    def GetLastOuterIterations(self) -> int:
        """Outer (power) iterations of the last SolveKeff."""
        return self._last_outers

    def GetLastInnerIterations(self) -> int:
        """CG iterations summed over the last SolveKeff."""
        return self._last_inners

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
        self._stale()
        self._built = True
        self._context()

    def initialize_cmfd(self):
        """CMFD's coupling data is part of every context: ensures the context."""
        self._context()

    def build_diagonal_cache(self):
        """The JAX facade builds its diagonal-A ("diag") context here at
        RT0-P0; the port has no diagonal A-solve yet."""
        if self._fes.k == 0 and self._fes.m == 0:
            raise NotImplementedError("the diagonal solver (a_mode 'diag') is not ported")

    def _context(self) -> Dict:
        """The operator context: built after BuildMatrices, and rebuilt here
        when the boundaries have changed since (``_stale``)."""
        if not self._built:
            raise RuntimeError("BuildMatrices() must be called before solving")
        if self._ctx is not None:
            return self._ctx
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
        return self._ctx

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
        ctx = self._context()
        if "schur_chol" not in ctx:
            self._log(VerbosityLevel.VERBOSE,
                      f"Building explicit Schur factors (n_phi={self._fes.n_phi})")
            attach_dense_schur(self._fes, ctx, "exact")
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
            accel=self._accel,
            inner_solver=inner_solver,
            use_cmfd=use_cmfd,
            cmfd_omega=self._cmfd_omega,
            inner_precond=os.environ.get("NEUTFEM_PRECOND", "auto"),
            tg_degree=int(os.environ.get("NEUTFEM_TG_DEGREE", "8")),
            tg_kappa=float(os.environ.get("NEUTFEM_TG_KAPPA", "30.0")),
        )

    def preconditioner(self) -> str:
        """The preconditioner the group solves run (the "auto" rule resolved)."""
        return resolve_precond(self._fes, self._context(), self._opts().inner_precond)

    def _flat_phi(self, value: float = 1.0):
        return torch.full((self._ng, *self._mesh.shape, self._fes.P), value,
                          dtype=self._dtype, device=self._device)

    def _coarse(self, factors: Sequence[int]):
        """coarse_init at (x, y, z) factors (missing ones 1): (k, fine phi0)."""
        f = tuple(int(v) for v in factors) + (1,) * max(0, 3 - len(factors))
        k_c, phi0 = coarse_init(self._fes, self._ng, self._xs, self._bcs, f[:3], self._opts(),
                                self._device, self._dtype, marshak_d_factor=True)
        return float(k_c), phi0

    def _maybe_profile(self):
        """A ``torch.profiler`` trace around a solve when NEUTFEM_PROFILE=<dir>
        is set, written into <dir> (the JAX facade's ``jax.profiler.trace``)."""
        trace_dir = os.environ.get("NEUTFEM_PROFILE")
        if not trace_dir:
            return contextlib.nullcontext()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))

    def _solve(self, opts: SolveOptions, phi0, keff0, adjoint: bool = False,
               fixed_keff=None):
        """One power iteration; returns (result, host [k, dk, dphi, finite]).
        Keeps the per-outer history and the last group solve's CG count and
        residual, and at VERBOSE prints the reference's line every 5 outers
        (NeutFEM.cpp:1791-1796), after the solve, as the JAX facade does
        where the device has no host callbacks."""
        res = power_iteration(self._fes, self._ng, opts, self._context(), phi0, keff0,
                              adjoint=adjoint, fixed_keff=fixed_keff)
        host = torch.stack([res["keff"], res["diff_k"], res["diff_flux"],
                            res["finite"].to(self._dtype),
                            res["last_inner_residual"].to(self._dtype)]).tolist()
        self._last_history = res["history"].cpu().numpy()
        self._last_schur_iterations = int(res["last_inner_iterations"])
        self._last_schur_residual = host.pop()
        if self._verbosity >= VerbosityLevel.VERBOSE:
            for i in range(0, len(self._last_history), 5):
                k, dk, dphi, inner = self._last_history[i]
                print(f"  It {i} : k = {k:.8f}  dk = {dk:.2e}  dphi = {dphi:.2e}"
                      f"  (inner {int(inner)})")
        return res, host

    def SolveKeff(self, use_coarse_init: bool = False, coarse_factors: Sequence[int] = (),
                  use_diagonal_solver: bool = False, use_cmfd: bool = False) -> float:
        if use_diagonal_solver:
            raise NotImplementedError("the diagonal solver (a_mode 'diag') is not ported")
        self._context()
        opts = self._opts(self._inner_solver(), use_cmfd=use_cmfd)
        keff0 = self._keff if self._keff else 1.0
        phi0 = self._phi if self._phi is not None else self._flat_phi()
        if use_coarse_init and len(coarse_factors) > 0:
            keff0, phi0 = self._coarse(coarse_factors)
            self._log(VerbosityLevel.NORMAL, f"  coarse init: k-eff = {keff0:.6f}")

        t0 = time.time()
        with self._maybe_profile():
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
        ctx = self._context()
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
            ip = biorthogonal_inner(ctx, self._phi, phi_adj)
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

    def SolveSubcritical(self) -> float:
        """Fixed-source subcritical solve (wrapper.cpp:700-715, unimplemented
        in the reference) at k = the last k or 1: returns the amplification
        factor M and keeps the with-fission flux.  Warns (``RuntimeWarning``)
        when the solve diverged: M > 1e6 or not finite."""
        ctx = self._context()
        opts = self._opts(self._inner_solver())
        res = solve_subcritical(self._fes, self._ng, opts, ctx, self._flat_phi(0.0),
                                keff=self._keff or 1.0)
        amp, finite = torch.stack([res["amplification"],
                                   res["finite"].to(self._dtype)]).tolist()
        self._phi = res["phi"]
        self._J = res["J"]
        self.subcritical_outers = (res["outer_iterations"], res["outer_iterations_no_fission"])
        if not (np.isfinite(amp) and finite) or amp > 1e6:
            warnings.warn(
                f"SolveSubcritical diverged (amplification M = {amp:.3e}): the system "
                "is supercritical (k >= 1) — the fixed-source problem has no bounded "
                "solution", RuntimeWarning, stacklevel=2)
        self._log(VerbosityLevel.NORMAL, f"SolveSubcritical: amplification M = {amp:.4f}")
        return amp

    def SolveCoarse(self, refine: Sequence[int]):
        """Coarse solve + P_0 injection (NeutFEM.cpp:2380-2611): sets the flux and
        k that the next SolveKeff starts from; returns (k, fine P_0 flux
        (ng, nz, ny, nx) as numpy)."""
        k_c, phi0 = self._coarse(refine)
        self._phi = phi0
        self._keff = k_c
        return k_c, phi0[..., 0].cpu().numpy()

    # -- projection / zoom (wrapper.cpp:1003-1064, unimplemented upstream) ----

    def _refine_factors(self, refine: Sequence[int]):
        r = list(refine) + [1] * (3 - len(refine))
        rx = max(int(r[0]), 1)
        ry = max(int(r[1]), 1) if self._mesh.dim >= 2 else 1
        rz = max(int(r[2]), 1) if self._mesh.dim == 3 else 1
        return rx, ry, rz

    def project_flux(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """Exact subcell averages of the polynomial flux on a refined mesh
        (host numpy)."""
        phi = self._phi_adj if adjoint else self._phi
        if phi is None:
            raise RuntimeError("no flux available: solve first")
        rx, ry, rz = self._refine_factors(refine)
        fes = self._fes
        phi = phi.cpu().numpy()  # (ng, nz, ny, nx, P)
        Ts = {0: _subcell_average_matrix(fes.m, rx),
              1: _subcell_average_matrix(fes.m, ry),
              2: _subcell_average_matrix(fes.m, rz)}
        ng, nz, ny, nx, P = phi.shape
        out = np.zeros((ng, nz * rz, ny * ry, nx * rx))
        for p in range(P):
            px, py, pz = fes.modes[p]
            # tensor outer product of the per-axis subcell averages
            wz = Ts[2][:, pz] if self._mesh.dim == 3 else np.ones(rz)
            wy = Ts[1][:, py] if self._mesh.dim >= 2 else np.ones(ry)
            wx = Ts[0][:, px]
            blk = (phi[..., p][:, :, None, :, None, :, None]
                   * wz[None, None, :, None, None, None, None]
                   * wy[None, None, None, None, :, None, None]
                   * wx[None, None, None, None, None, None, :])
            out += blk.reshape(ng, nz * rz, ny * ry, nx * rx)
        return self._squeeze(out)

    def project_power(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """kappa-Sigma_f * flux on the refined mesh (wrapper.cpp:1024-1043)."""
        rx, ry, rz = self._refine_factors(refine)
        flux = self.project_flux(refine, adjoint)  # squeezed refined flux
        ksf = self._xs["KSF"]
        ksf_f = np.repeat(np.repeat(np.repeat(ksf, rz, axis=1), ry, axis=2), rx, axis=3)
        return (self._squeeze(ksf_f) * flux).sum(axis=0)

    def zoom_resolved(self, refine: Sequence[int], adjoint: bool = False) -> np.ndarray:
        """Re-solve on a refined mesh with the fission source frozen from the
        current solution (wrapper.cpp:1047-1064): a fixed-source solve of the
        refined context on the facade's device.  Returns the refined P_0 flux."""
        phi = self._phi_adj if adjoint else self._phi
        if phi is None or self._keff is None:
            raise RuntimeError("no solution available: solve first")
        rx, ry, rz = self._refine_factors(refine)

        def refine_breaks(b, r):
            if r == 1 or b.size < 2:
                return b
            segs = [np.linspace(b[i], b[i + 1], r + 1)[:-1] for i in range(b.size - 1)]
            return np.append(np.concatenate(segs), b[-1])

        m = self._mesh
        fmesh = CartesianMesh.from_breaks(
            refine_breaks(m.x_breaks, rx),
            refine_breaks(m.y_breaks, ry) if m.dim >= 2 else m.y_breaks[:1],
            refine_breaks(m.z_breaks, rz) if m.dim == 3 else m.z_breaks[:1],
        )
        ffes = make_fespace(fmesh, self._fes.k, self._fes.m)

        def rep(a):
            return np.repeat(np.repeat(np.repeat(a, rz, axis=-3), ry, axis=-2), rx, axis=-1)

        fxs = {k: rep(v) for k, v in self._xs.items()}
        # the frozen fission source, projected onto the refined cells
        full = np.zeros((self._ng, *fmesh.shape))
        self._squeeze(full)[...] = self.project_flux((rx, ry, rz), adjoint)
        fiss = (rep(self._xs["NSF"]) * full).sum(axis=0)
        fxs["SRC"] = rep(self._xs["Chi"]) * fiss[None] / self._keff
        fxs["NSF"] = np.zeros_like(fxs["NSF"])  # fission frozen into SRC

        fctx = build_context(ffes, self._ng, fxs, self._bcs, device=self._device,
                             dtype=self._dtype, marshak_d_factor=True)
        phi0 = torch.zeros((self._ng, *fmesh.shape, ffes.P), dtype=self._dtype,
                           device=self._device)
        res = fixed_source_solve(ffes, self._ng, self._opts(), fctx, phi0,
                                 with_fission=False)
        return self._squeeze(res["phi"][..., 0].cpu().numpy())

    # -- checkpoint / resume (new scope; the reference has none) --------------

    @staticmethod
    def _ckpt_path(path: str) -> str:
        # np.savez_compressed appends ".npz" when missing; normalize both ends
        return path if str(path).endswith(".npz") else str(path) + ".npz"

    def save_state(self, path: str):
        """Persist the solver state (flux, adjoint, currents, eigenvalues) to
        .npz, in the JAX facade's format; the axis order is always the user's,
        ``axperm`` (0, 1, 2)."""
        data = {"keff": np.array(self._keff if self._keff is not None else np.nan),
                "keff_adj": np.array(self._keff_adj if self._keff_adj is not None else np.nan),
                "axperm": np.array((0, 1, 2), dtype=np.int64)}
        if self._phi is not None:
            data["phi"] = self._phi.cpu().numpy()
        if self._phi_adj is not None:
            data["phi_adj"] = self._phi_adj.cpu().numpy()
        for jname, J in (("J", self._J), ("J_adj", self._J_adj)):
            for dkey, entry in (J or {}).items():
                for part, arr in entry.items():
                    data[f"{jname}_{dkey}_{part}"] = arr.cpu().numpy()
        np.savez_compressed(self._ckpt_path(path), **data)

    def load_state(self, path: str):
        """Restore a state saved by either facade's save_state (warm-starts
        later solves).  Currents saved under another axis order than (0, 1, 2)
        are dropped with the JAX facade's warning; flux and eigenvalues load."""
        def tensor(a):
            return torch.as_tensor(a, dtype=self._dtype, device=self._device)

        with np.load(self._ckpt_path(path)) as z:
            expected = (self._ng, *self._mesh.shape, self._fes.P)
            if "phi" in z and tuple(z["phi"].shape) != expected:
                raise ValueError(
                    f"checkpoint flux shape {z['phi'].shape} does not match this "
                    f"solver's {expected} (mesh/groups/order differ)")
            if "phi" in z:
                self._phi = tensor(z["phi"])
            if "phi_adj" in z:
                self._phi_adj = tensor(z["phi_adj"])
            k, ka = float(z["keff"]), float(z["keff_adj"])
            self._keff = None if np.isnan(k) else k
            self._keff_adj = None if np.isnan(ka) else ka
            saved_perm = tuple(int(v) for v in z["axperm"]) if "axperm" in z else (0, 1, 2)
            if saved_perm != (0, 1, 2):
                warnings.warn(
                    f"checkpoint currents were saved with internal axis order "
                    f"{saved_perm} but this solver uses (0, 1, 2); "
                    "dropping J/J_adj (flux and eigenvalues are restored)", RuntimeWarning)
                self._J = None
                self._J_adj = None
                return
            J: Dict = {}
            J_adj: Dict = {}
            for key in z.files:
                for prefix, target in (("J_adj_", J_adj), ("J_", J)):
                    if key.startswith(prefix):
                        dkey, part = key[len(prefix):].rsplit("_", 1)
                        target.setdefault(dkey, {})[part] = tensor(z[key])
                        break
            self._J = J or None
            self._J_adj = J_adj or None

    # -- export -----------------------------------------------------------------

    def _cell_current(self, J) -> Optional[np.ndarray]:
        """(ng, nz, ny, nx, 3) cell-average current vectors: the mean of the two
        opposing face values per direction (the reference's VTK convention),
        brought to the host in one read."""
        if J is None:
            return None
        ctx = self._context()
        out = torch.zeros((self._ng, *self._mesh.shape, 3), dtype=self._dtype,
                          device=self._device)
        for di in self._fes.dirs:
            key = f"d{di.d}"
            F = J[key]["face"][..., 0] * ctx[f"jscale_{key}"]  # t = 0 transverse mode
            n = F.shape[di.axis + 1]
            out[..., di.d] = 0.5 * (F.narrow(di.axis + 1, 0, n - 1)
                                    + F.narrow(di.axis + 1, 1, n - 1))
        return out.cpu().numpy()

    def ExportVTK(self, filename: str, export_flux: bool = True,
                  export_current: bool = True, export_xs: bool = False,
                  export_adjoint: bool = False) -> None:
        flux = self.get_flux_full() if export_flux else None
        adj = self.get_flux_adj_full() if export_adjoint else None
        cur = self._cell_current(self._J) if export_current and self._J else None
        write_vtk(filename, self._mesh, self._keff or 0.0, flux=flux, flux_adj=adj,
                  current=cur, xs=self._xs if export_xs else None)

    def ExportFluxVTK(self, filename: str) -> None:
        write_vtk(filename, self._mesh, self._keff or 0.0, flux=self.get_flux_full())

    def ExportXSVTK(self, filename: str) -> None:
        write_vtk(filename, self._mesh, self._keff or 0.0, xs=self._xs)
