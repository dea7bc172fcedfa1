"""Fixed-source and subcritical solves, flux projection and zoom, checkpoints
and the VTK export of the port against neutfem_tpu (float64, CPU).

* ``power.fixed_source_solve`` with and without fission on a random 2-group
  problem whose source lies in the thermal group only: with no upscatter the
  fast group's right-hand side is zero in the source-only solve, whose CG
  must then return x = 0; flux to rel 1e-9, identical outer counts;
* ``SolveSubcritical`` on ``examples/subcritical_source.py``'s problem at
  n = 8 (``SolveKeff``, ``reset_flux``, then the source solve at k = 1): M
  to rel 1e-9; a supercritical problem makes both facades warn;
* ``project_flux``, ``project_power`` and ``zoom_resolved`` on IAEA-2D 1x1:
  rel 1e-9 against the JAX facade; the projection keeps the cell averages
  and the zoom stays within ``tests/test_compat_api.py``'s bounds of it;
* ``save_state`` / ``load_state``: a round trip through the port, and
  checkpoints written by one facade and loaded by the other, both ways;
* ``ExportVTK``: the fields ``test_vtk_export`` checks, and the JAX facade's
  file, number for number.
"""

import re
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import neutfem
from benchmarks.data import BENCHMARKS
from benchmarks.runner import BenchmarkRun as JRun
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu.bc import BCKind as JBCKind
from neutfem_tpu.bc import BCSpec as JBCSpec
from neutfem_tpu.ops.context import build_context as j_build_context
from neutfem_tpu.power import SolveOptions as JSolveOptions
from neutfem_tpu.power import fixed_source_solve as j_fixed_source_solve
from neutfem_tpu_torch import compat
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch.bc import BCKind, BCSpec
from neutfem_tpu_torch.bench import BenchmarkRun
from neutfem_tpu_torch.ops.context import build_context
from neutfem_tpu_torch.power import SolveOptions, fixed_source_solve

torch.set_num_threads(1)

F64 = torch.float64
TOL = (1e-6, 1e-5, 1e-5, 300, 1000)  # the benchmark tests' tolerances


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _torch_facade(*args):
    return compat.NeutFEM(*args, device="cpu", dtype=F64)


@pytest.mark.parametrize("with_fission", [True, False], ids=["fission", "source_only"])
def test_fixed_source_solve_matches_jax(with_fission):
    rng = np.random.default_rng(31)
    shape = (3, 4, 5)
    breaks = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.8, 1.4, n))])
              for n in shape[::-1]]
    ng = 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.05, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.03, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    xs["SigS"][1, 0] = rng.uniform(0.01, 0.03, shape)  # downscatter only
    xs["SRC"][1] = rng.uniform(0.5, 1.5, shape)         # a thermal source only
    jb, tb = JBCSpec(), BCSpec()
    for ax in range(3):
        for up in (False, True):
            kind = "DIRICHLET" if up else "MIRROR"
            jb.set(j_mesh.boundary_attribute(3, ax, up), JBCKind[kind])
            tb.set(t_mesh.boundary_attribute(3, ax, up), BCKind[kind])
    jfes = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    tfes = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(*breaks), 0, 0)
    jctx = j_build_context(jfes, ng, xs, jb, a_mode="exact", dtype=jnp.float64)
    tctx = build_context(tfes, ng, xs, tb, device="cpu", dtype=F64)
    kw = dict(tol_flux=1e-8, inner_tol=1e-10, inner_eta=0.03, max_outer=100)
    phi0 = np.zeros((ng, *shape, 1))
    jres = j_fixed_source_solve(jfes, ng, JSolveOptions(**kw), jctx, jnp.asarray(phi0),
                                with_fission=with_fission, keff=1.1)
    tres = fixed_source_solve(tfes, ng, SolveOptions(**kw), tctx, torch.tensor(phi0),
                              with_fission=with_fission, keff=1.1)
    assert tres["outer_iterations"] == int(jres["outer_iterations"]) > 1
    assert abs(tres["inner_iterations"] - int(jres["inner_iterations"])) <= 2
    assert _rel(tres["phi"].numpy(), np.asarray(jres["phi"])) <= 1e-9
    assert bool(tres["finite"])
    if not with_fission:  # the fast group's zero right-hand side
        assert not tres["phi"][0].any() and tres["phi"][1].min() > 0


def _example(make, n=8):
    """``examples/subcritical_source.py``'s problem at n x n."""
    s = make(0, 2, np.linspace(0, 100, n + 1), np.linspace(0, 100, n + 1), np.array([0.0]))
    s.set_verbosity(0)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, compat.BCType.DIRICHLET)
    s.get_D()[0], s.get_D()[1] = 1.4, 0.4
    s.get_SigR()[0], s.get_SigR()[1] = 0.028, 0.10
    s.get_NSF()[0], s.get_NSF()[1] = 0.003, 0.07  # subcritical loading
    s.get_Chi()[0] = 1.0
    s.get_SigS()[1, 0] = 0.018
    s.get_SRC()[0, n // 2, n // 2] = 1.0  # point source, fast group
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-7, 1e-9, 300)
    return s


def test_subcritical_example_matches_jax():
    out = []
    for make in (neutfem.NeutFEM, _torch_facade):
        s = _example(make)
        k = s.SolveKeff()
        s.reset_flux()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # no divergence warning
            out.append((k, s.SolveSubcritical(), s.get_flux()))
    (kj, mj, fj), (kt, mt, ft) = out
    assert kt < 1.0 and abs(kt - kj) <= 1e-7
    assert mt > 1.0 and abs(mt - mj) <= 1e-9 * mj
    assert _rel(ft, fj) <= 1e-9
    assert s.subcritical_outers[0] > s.subcritical_outers[1] >= 1


@pytest.mark.parametrize("facade", ["jax", "torch"])
def test_subcritical_warns_when_supercritical(facade):
    """A one-group square with mirror faces and k_inf = 3: the source
    iteration at k = 1 diverges."""
    make = neutfem.NeutFEM if facade == "jax" else _torch_facade
    s = make(0, 1, np.linspace(0.0, 8.0, 5), np.linspace(0.0, 8.0, 5), np.array([0.0]))
    s.set_verbosity(0)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, compat.BCType.MIRROR)
    s.get_SigR()[...] = 0.05
    s.get_NSF()[...] = 0.15
    s.get_SRC()[...] = 1.0
    s.BuildMatrices()
    s.set_tol(1e-6, 1e-5, 1e-5, 40)
    with pytest.warns(RuntimeWarning, match="SolveSubcritical diverged"):
        s.SolveSubcritical()


@pytest.fixture(scope="module")
def iaea2d_pair():
    """IAEA-2D 1x1 through both facades: a direct and an adjoint solve."""
    spec = BENCHMARKS["iaea2d"]
    runs = (JRun(spec, mesh_n=1).solver,
            BenchmarkRun(spec, mesh_n=1, device="cpu", dtype=F64).solver)
    for s in runs:
        s.set_tol(*TOL)
        s.SolveKeff()
        s.SolveAdjoint()
    return runs


def test_projection_and_zoom_match_jax(iaea2d_pair):
    j, t = iaea2d_pair
    n = 19
    assert abs(t.GetLastKeff() - j.GetLastKeff()) <= 1e-9
    fr, pw, zr = (t.project_flux([2, 2, 1]), t.project_power([2, 2, 1]),
                  t.zoom_resolved([2, 2, 1]))
    assert fr.shape == zr.shape == (2, 2 * n, 2 * n) and pw.shape == (2 * n, 2 * n)
    assert _rel(fr, j.project_flux([2, 2, 1])) <= 1e-9
    assert _rel(pw, j.project_power([2, 2, 1])) <= 1e-9
    assert _rel(t.project_flux([2, 2, 1], adjoint=True),
                j.project_flux([2, 2, 1], adjoint=True)) <= 1e-9
    assert _rel(zr, j.zoom_resolved([2, 2, 1])) <= 1e-9
    # subcell averages preserve the cell average
    np.testing.assert_allclose(fr.reshape(2, n, 2, n, 2).mean(axis=(2, 4)), t.get_flux(),
                               rtol=1e-12, atol=1e-14)
    # the zoom resolves sub-cell detail: near the projection, not equal to it
    assert np.max(np.abs(zr - fr)) / np.max(np.abs(fr)) < 0.25
    assert abs(zr.mean() - fr.mean()) / fr.mean() < 0.02


def _fresh(facade):
    spec = BENCHMARKS["iaea2d"]
    s = (JRun(spec, mesh_n=1).solver if facade == "jax"
         else BenchmarkRun(spec, mesh_n=1, device="cpu", dtype=F64).solver)
    s.set_tol(*TOL)
    return s


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_round_trips(iaea2d_pair, tmp_path, writer, reader):
    src = dict(zip(("jax", "torch"), iaea2d_pair))[writer]
    src.save_state(str(tmp_path / "state"))  # ".npz" appended and found again
    dst = _fresh(reader)
    dst.load_state(str(tmp_path / "state"))
    assert dst.GetLastKeff() == src.GetLastKeff()
    assert dst.GetLastKeffAdjoint() == src.GetLastKeffAdjoint()
    np.testing.assert_array_equal(dst.get_flux(), src.get_flux())
    np.testing.assert_array_equal(dst.get_flux_adj(), src.get_flux_adj())
    for d in ("d0", "d1"):
        np.testing.assert_array_equal(np.asarray(dst._J[d]["face"]),
                                      np.asarray(src._J[d]["face"]))
    k = dst.SolveKeff()  # the warm restart converges at once
    assert abs(k - src.GetLastKeff()) <= 1e-7 and dst.GetLastOuterIterations() <= 5


def test_checkpoint_of_another_axis_order_drops_currents(iaea2d_pair, tmp_path):
    t = iaea2d_pair[1]
    t.save_state(str(tmp_path / "state.npz"))
    with np.load(tmp_path / "state.npz") as z:
        data = dict(z)
    data["axperm"] = np.array([1, 0, 2])
    np.savez(tmp_path / "perm.npz", **data)
    dst = _fresh("torch")
    with pytest.warns(RuntimeWarning, match="dropping J/J_adj"):
        dst.load_state(str(tmp_path / "perm.npz"))
    assert dst._J is None and dst.GetLastKeff() == t.GetLastKeff()
    np.testing.assert_array_equal(dst.get_flux(), t.get_flux())
    data["phi"] = data["phi"][:, :, :-1]
    np.savez(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="does not match"):
        dst.load_state(str(tmp_path / "bad.npz"))


def _vtk_numbers(path):
    with open(path) as f:
        text = f.read()
    heads = re.findall(r"^(?:SCALARS|VECTORS|CELL_DATA|DIMENSIONS|POINTS) .*$", text, re.M)
    body = [ln for ln in text.splitlines()[4:] if ln and not ln[0].isalpha()]
    return text, heads, np.array([float(v) for ln in body for v in ln.split()])


def test_vtk_export_matches_jax(iaea2d_pair, tmp_path):
    for s, name in zip(iaea2d_pair, ("jax", "torch")):
        s.ExportVTK(str(tmp_path / name), export_flux=True, export_current=True,
                    export_xs=True, export_adjoint=True)
    text, heads, values = _vtk_numbers(tmp_path / "torch.vtk")
    _, jheads, jvalues = _vtk_numbers(tmp_path / "jax.vtk")
    assert "DATASET STRUCTURED_GRID" in text
    for field in ("Flux_g0", "Flux_g1", "Flux_total", "Flux_adj_g0", "Current_g0",
                  "D_g0", "SigmaR_g1", "NuSigF_g1", "Chi_g0", "KappaSigF_g0",
                  "Source_g0", "SigS_0_to_1"):
        assert field in text, field
    n_cells_line = [ln for ln in text.splitlines() if ln.startswith("CELL_DATA")][0]
    assert int(n_cells_line.split()[1]) == 19 * 19
    assert heads == jheads
    np.testing.assert_allclose(values, jvalues, rtol=1e-8, atol=1e-12 * np.abs(jvalues).max())
    t = iaea2d_pair[1]
    t.ExportFluxVTK(str(tmp_path / "flux"))
    t.ExportXSVTK(str(tmp_path / "xs.vtk"))
    assert "Flux_total" in open(tmp_path / "flux.vtk").read()
    assert "SigS_1_to_0" in open(tmp_path / "xs.vtk").read()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
