"""Paths the port runs that no other CPU test holds against neutfem_tpu:
1D meshes (RT0-P0, RT1-P1, RT2-P2 and the RT0 adjoint) and the spaces
RT_k-P_m with m < k (3D RT2-P1 and RT1-P0, 2D RT1-P0), at float64 on random
2-group problems: |dk| <= 1e-9, the same outer count, inners within 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_jitted
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu_torch.ops.context import ctx_from_numpy
from neutfem_tpu_torch.power import SolveOptions, power_iteration

torch.set_num_threads(1)

F64 = torch.float64


def _problem(shape, k, m, seed=0):
    """A random 2-group problem with downscatter on ``shape`` (nz, ny, nx;
    2D where nz = 1, 1D where ny = 1 too), MIRROR on the lower and vacuum on
    the upper faces: (fes, JAX context, port context)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    dim = 1 if ny == 1 else 2 if nz == 1 else 3
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
          for n in (nx, ny, nz)[:dim]])
    fes = j_fespace.make_fespace(mesh, k, m)
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.zeros((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)
    bcs = BCSpec()
    for ax in range(dim):
        bcs.set(j_mesh.boundary_attribute(dim, ax, False), BCKind.MIRROR)
        bcs.set(j_mesh.boundary_attribute(dim, ax, True), BCKind.DIRICHLET)
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    return fes, jctx, ctx_from_numpy({key: np.asarray(v) for key, v in jctx.items()}, "cpu", F64)


@pytest.mark.parametrize("shape,k,m,adjoint", [
    ((1, 1, 9), 0, 0, False),
    ((1, 1, 9), 1, 1, False),
    ((1, 1, 9), 2, 2, False),
    ((1, 1, 9), 0, 0, True),
    ((2, 2, 2), 2, 1, False),
    ((2, 2, 3), 1, 0, False),
    ((1, 3, 4), 1, 0, False),
], ids=["1d-rt0", "1d-rt1", "1d-rt2", "1d-rt0-adjoint", "3d-rt2p1", "3d-rt1p0", "2d-rt1p0"])
def test_power_iteration_matches_jax(shape, k, m, adjoint):
    fes, jctx, tctx = _problem(shape, k, m)
    kw = dict(tol_keff=1e-9, tol_flux=1e-8, inner_tol=1e-10, max_outer=200)
    want = jax_jitted.power_iteration(fes, 2, JSolveOptions(**kw), jctx,
                                      jnp.ones((2, *fes.mesh.shape, fes.P)), 1.0, adjoint=adjoint)
    got = power_iteration(fes, 2, SolveOptions(**kw), tctx,
                          torch.ones((2, *fes.mesh.shape, fes.P), dtype=F64), 1.0,
                          adjoint=adjoint)
    assert abs(float(got["keff"]) - float(want["keff"])) <= 1e-9
    assert got["outer_iterations"] == int(want["outer_iterations"])
    assert abs(got["inner_iterations"] - int(want["inner_iterations"])) <= 2
