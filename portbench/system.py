"""The system under test: ``neutfem_tpu_torch.compat.NeutFEM``, driven through
its public surface.  The only module of the benchmark that imports the port,
and it does so inside its functions, after ``run`` has set the environment.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

__all__ = ["make_solver", "solve", "state", "clone_state", "to_host", "counts", "build_seconds"]


def make_solver(config: Dict, inputs, device: str):
    """A facade for the configuration on ``device``, filled with ``inputs``
    through its getters, the tolerances set and ``BuildMatrices`` run.
    Returns (solver, seconds of the benchmark's own span around BuildMatrices)."""
    import torch
    from neutfem_tpu_torch.compat import BCType, LinearSolverType, NeutFEM, VerbosityLevel
    from neutfem_tpu_torch.mesh import boundary_attribute

    disc = config["discretization"]
    dtype = {"float32": torch.float32, "float64": torch.float64}[disc["dtype"]]
    s = NeutFEM(disc["rt_order"], disc["p_order"], config["core"]["ng"], inputs.x_breaks,
                inputs.y_breaks, inputs.z_breaks, device=device, dtype=dtype)
    s.set_verbosity(VerbosityLevel.SILENT)
    s.set_linear_solver(getattr(LinearSolverType, config["facade"]["linear_solver"]))
    for axis in range(inputs.dim):  # vacuum (Marshak) on every outer face
        for upper in (False, True):
            s.set_bc(boundary_attribute(inputs.dim, axis, upper), BCType.DIRICHLET, 0.0)

    def sq(a):
        return a[..., 0, :, :] if inputs.dim == 2 else a

    xs = inputs.xs
    s.get_D()[:] = sq(xs["D"])
    s.get_SigR()[:] = sq(xs["SigR"])
    s.get_NSF()[:] = sq(xs["NSF"])
    s.get_Chi()[:] = sq(xs["Chi"])
    s.get_SigS()[:] = sq(xs["SigS"])
    s.get_KSF()[:] = sq(xs["NSF"])  # power proxy, as BenchmarkRun
    tol = config["tol"]
    s.set_tol(tol["keff"], tol["flux"], tol["l2"], tol["max_outer"], tol["max_inner"])
    t0 = time.perf_counter()
    s.BuildMatrices()
    if device == "cuda":
        torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def solve(s) -> float:
    """One cold solve: ``reset_flux`` then ``SolveKeff``, which ends in a read
    of k on the host.  Returns k."""
    s.reset_flux()
    return s.SolveKeff()


def counts(s) -> Tuple[int, int]:
    """(outer, inner) iterations of the last solve."""
    return s.GetLastOuterIterations(), s.GetLastInnerIterations()


def build_seconds(s) -> Dict[str, float]:
    """The program's own host clock of its last context build (context, two-grid)."""
    return dict(s.build_seconds)


def state(s):
    """The answer of the last solve as ``save_state`` writes it: (k, phi
    (ng, nz, ny, nx, P), J {"d<d>": {"face", "bub"}}), as device tensors."""
    return s.GetLastKeff(), s._phi, s._J


def clone_state(s):
    """``state`` copied on the device, to outlive the next solve."""
    k, phi, J = state(s)
    return k, phi.clone(), {key: {p: t.clone() for p, t in e.items()} for key, e in J.items()}


def to_host(answer) -> Tuple[float, np.ndarray, Dict]:
    """An answer's arrays as host numpy float64."""
    k, phi, J = answer
    return (float(k), phi.double().cpu().numpy(),
            {key: {p: t.double().cpu().numpy() for p, t in e.items()} for key, e in J.items()})
