"""Nonzero NEUMANN boundaries (a prescribed inward current) in the port,
against neutfem_tpu and the analytic slab, at float64 on the CPU.

The value is an inhomogeneous essential condition on the current DOF, lifted
as J = J' + J_q: ``jcorr`` is added to the output current and ``src_bc`` to
every fixed-source group rhs (``ops/context.py``).  Held here: both against
the JAX ``build_context`` (rel <= 1e-12); the 1D pure-absorber slab
(balance, profile and boundary current, ``tests/test_neumann_source.py``'s
bounds); the 2D balance; the facade's boundary-driven ``SolveSubcritical``
against the JAX facade (M and flux rel <= 1e-9).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind, BCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import SolveOptions, fixed_source_solve

torch.set_num_threads(1)

F64 = torch.float64
N, M, D = BCKind.NEUMANN, BCKind.MIRROR, BCKind.DIRICHLET


def _xs(shape, D_=1.0, siga=0.05, ng=1):
    return {"D": np.full((ng, *shape), D_), "SigR": np.full((ng, *shape), siga),
            "NSF": np.zeros((ng, *shape)), "Chi": np.ones((ng, *shape)),
            "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}


@pytest.mark.parametrize("k", [0, 1])
def test_lift_matches_jax(k):
    """jcorr on the NEUMANN directions and src_bc (one lower and one upper
    end, values of both signs, a random 2-group 3D problem), with every other
    key of the context."""
    rng = np.random.default_rng(0)
    shape = (3, 4, 5)
    mesh = j_mesh.CartesianMesh.from_breaks(
        *[np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))]) for n in (5, 4, 3)])
    fes = j_fespace.make_fespace(mesh, k, k)
    xs = {"D": rng.uniform(0.3, 2.0, (2, *shape)), "SigR": rng.uniform(0.01, 0.2, (2, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (2, *shape)), "Chi": np.ones((2, *shape)),
          "SigS": np.zeros((2, 2, *shape)), "SRC": np.zeros((2, *shape))}
    bcs = BCSpec()
    for ax in range(3):
        for up in (False, True):
            bcs.set(j_mesh.boundary_attribute(3, ax, up), D)
    bcs.set(j_mesh.boundary_attribute(3, 2, False), N, 0.7)
    bcs.set(j_mesh.boundary_attribute(3, 0, True), N, -0.3)
    bcs.set(j_mesh.boundary_attribute(3, 1, True), M)
    jctx = j_build_context(fes, 2, xs, bcs, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(fes, 2, xs, bcs, "cpu", F64)
    assert {"src_bc", "jcorr_d0", "jcorr_d2"} <= set(tctx) and "jcorr_d1" not in tctx
    for key, v in jctx.items():
        if key.startswith("tri_hoxT_"):  # lane-packed in the JAX package
            continue
        want = np.asarray(v)
        assert np.max(np.abs(tctx[key].numpy() - want)) <= (
            1e-12 * max(np.max(np.abs(want)), 1e-300)), key


def _slab(nx, a, D_, siga, q):
    mesh = j_mesh.CartesianMesh.from_breaks(np.linspace(0.0, a, nx + 1))
    fes = j_fespace.make_fespace(mesh, 0, 0)
    bcs = BCSpec()
    bcs.set(j_mesh.boundary_attribute(1, 0, False), N, q)
    bcs.set(j_mesh.boundary_attribute(1, 0, True), M)
    return mesh, fes, build_context(fes, 1, _xs(mesh.shape, D_, siga), bcs, "cpu", F64)


def test_neumann_analytic_slab():
    """1D pure absorber [0, a], inward current q on the left, MIRROR on the
    right: absorption = q, phi(x) = q cosh(kappa (a - x)) / (D kappa sinh(kappa
    a)) to O(h^2), the boundary current q, zero at the mirror."""
    nx, a, D_, siga, q = 200, 40.0, 1.2, 0.05, 1.0
    mesh, fes, ctx = _slab(nx, a, D_, siga, q)
    res = fixed_source_solve(fes, 1, SolveOptions(tol_flux=1e-11, inner_tol=1e-13, max_outer=50),
                             ctx, torch.zeros((1, *mesh.shape, 1), dtype=F64), with_fission=False)
    phi = res["phi"][0, 0, 0, :, 0].numpy()
    h = a / nx
    assert float(np.sum(siga * phi * h)) == pytest.approx(q, rel=1e-8)
    kappa = np.sqrt(siga / D_)
    xc = (np.arange(nx) + 0.5) * h
    exact = q * np.cosh(kappa * (a - xc)) / (D_ * kappa * np.sinh(kappa * a))
    np.testing.assert_allclose(phi, exact, rtol=2e-3)
    F = res["J"]["d0"]["face"][0, 0, 0, :, 0].numpy()
    assert F[0] * float(ctx["jscale_d0"][0, 0, 0]) == pytest.approx(q, rel=1e-10)
    assert abs(F[-1]) < 1e-12


def test_neumann_2d_balance():
    """2D: an inward current on the left edge, MIRROR elsewhere: the total
    absorption is the inflow q * L."""
    n, L, D_, siga, q = 24, 48.0, 1.0, 0.08, 0.7
    mesh = j_mesh.CartesianMesh.from_breaks(np.linspace(0, L, n + 1), np.linspace(0, L, n + 1))
    fes = j_fespace.make_fespace(mesh, 0, 0)
    bcs = BCSpec()
    bcs.set(j_mesh.boundary_attribute(2, 0, False), N, q)
    for ax, up in ((0, True), (1, False), (1, True)):
        bcs.set(j_mesh.boundary_attribute(2, ax, up), M)
    ctx = build_context(fes, 1, _xs(mesh.shape, D_, siga), bcs, "cpu", F64)
    res = fixed_source_solve(fes, 1, SolveOptions(tol_flux=1e-11, inner_tol=1e-13, max_outer=50),
                             ctx, torch.zeros((1, *mesh.shape, 1), dtype=F64), with_fission=False)
    h = L / n
    assert float(torch.sum(siga * res["phi"][0, 0, :, :, 0]) * h * h) == pytest.approx(
        q * L, rel=1e-8)


def test_facade_boundary_driven_subcritical_matches_jax():
    """SolveSubcritical of a 2-group 2D core driven only by an inward current
    on its left edge (no volume source), both facades: M and the flux."""
    from neutfem import BCType as JBCType
    from neutfem import NeutFEM as JNeutFEM
    from neutfem import VerbosityLevel as JVerbosity
    from neutfem_tpu_torch.compat import BCType, BoundaryID, NeutFEM, VerbosityLevel

    n = 6
    breaks = (np.linspace(0, 12.0, n + 1), np.linspace(0, 12.0, n + 1), np.array([0.0]))
    out = []
    for cls, bct, verb, kw in ((JNeutFEM, JBCType, JVerbosity, {}),
                               (NeutFEM, BCType, VerbosityLevel,
                                {"device": "cpu", "dtype": F64})):
        s = cls(0, 2, *breaks, **kw)
        s.set_verbosity(verb.SILENT)
        s.set_bc(int(BoundaryID.LEFT_2D), bct.NEUMANN, 0.5)
        for bid in (BoundaryID.RIGHT_2D, BoundaryID.TOP_2D, BoundaryID.BOTTOM_2D):
            s.set_bc(int(bid), bct.MIRROR)
        s.get_D()[0], s.get_D()[1] = 1.4, 0.4
        s.get_SigR()[0], s.get_SigR()[1] = 0.03, 0.1
        s.get_NSF()[1] = 0.09
        s.get_SigS()[1, 0] = 0.02
        s.set_tol(1e-8, 1e-10, 1e-10, 300, 1000)
        s.BuildMatrices()
        out.append((s.SolveSubcritical(), np.asarray(s.get_flux())))
    (mj, fj), (mt, ft) = out
    assert np.isfinite(mt) and mt > 1.0
    assert abs(mt - mj) <= 1e-9 * mj
    assert np.max(np.abs(ft - fj)) <= 1e-9 * np.max(np.abs(fj))
