"""The port's NeutFEM facade surface against the JAX facade (float64, CPU).

* ``set_bc`` after ``BuildMatrices``: the next solve rebuilds the context (the
  JAX facade clears its context cache) and both facades give the same k
  (|dk| <= 1e-9) and outer count; a solve before any ``BuildMatrices``
  raises.  The cores are IAEA-2D and KOEBERG 2x2: on a uniform 6x6 box a
  1e-15 change of the start flux alone moves the port's k by ~1e-6 at these
  tolerances, so the box cannot hold 1e-9;
* construction by keyword, both overloads; the card by default: without a
  CUDA device a construction that does not ask for the CPU raises;
* the getters and the ``GetLast*`` diagnostics against the JAX facade;
* ``set_robin_coefficients`` (a ROBIN boundary's albedo) after a first solve;
* the VERBOSE per-outer lines, the same lines as the JAX facade prints;
* ``NEUTFEM_PROFILE``: a ``torch.profiler`` trace of ``SolveKeff``;
* the quarter core ``quart_so`` and the half core ``moitie_s`` of IAEA-2D
  2x2 (``bench.BenchmarkRun`` domains): each against the JAX runner's
  (|dk| <= 1e-9, the same outers) and against the full core, as
  ``tests/test_benchmarks.py`` holds the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import neutfem
from benchmarks.data import BENCHMARKS
from benchmarks.runner import BenchmarkRun as JRun
from neutfem_tpu_torch import compat
from neutfem_tpu_torch.bench import BenchmarkRun

torch.set_num_threads(1)

F64 = torch.float64
TOL = (1e-6, 1e-5, 1e-5, 300, 1000)  # the benchmark tests' tolerances


def _pair(core, n=2, **kw):
    spec = BENCHMARKS[core]
    return (JRun(spec, mesh_n=n, **kw).solver,
            BenchmarkRun(spec, mesh_n=n, device="cpu", dtype=F64, **kw).solver)


def _solve(s, **kw):
    s.set_tol(*TOL)
    return s.SolveKeff(**kw), s.GetLastOuterIterations(), s.GetLastInnerIterations()


@pytest.mark.parametrize("core", ["iaea2d", "koeberg2d"])
def test_set_bc_after_build_matrices_matches_jax(core):
    """Solve, MIRROR on the left face, then a cold solve: the port rebuilds
    its context at the second solve (rather than raising "BuildMatrices()
    must be called before solving"), and the old context's CG plans go."""
    out = []
    for s in _pair(core):
        _solve(s)
        old = s._ctx if isinstance(s, compat.NeutFEM) else None
        s.set_bc(int(compat.BoundaryID.LEFT_2D), compat.BCType.MIRROR)
        s.reset_flux()
        out.append(_solve(s))
        if old is not None:
            assert s._ctx is not old and "cg_plans" not in old
    (kj, oj, ij), (kt, ot, it) = out
    assert abs(kt - kj) <= 1e-9
    assert ot == oj
    assert abs(it - ij) <= 2


def test_solve_before_build_matrices_raises():
    s = compat.NeutFEM(0, 2, np.linspace(0.0, 4.0, 5), np.linspace(0.0, 4.0, 5), [0.0],
                       device="cpu", dtype=F64)
    for solve in (s.SolveKeff, s.SolveAdjoint, s.SolveSubcritical, s.initialize_cmfd):
        with pytest.raises(RuntimeError, match="BuildMatrices"):
            solve()


def test_keyword_constructor_matches_jax():
    xb, yb, zb = np.linspace(0.0, 6.0, 4), np.linspace(0.0, 4.0, 3), np.linspace(0.0, 2.0, 3)
    for kw in (dict(order=1, ng=2), dict(rt_order=1, p_order=0, ng=2)):
        j = neutfem.NeutFEM(x_breaks=xb, y_breaks=yb, z_breaks=zb, **kw)
        t = compat.NeutFEM(x_breaks=xb, y_breaks=yb, z_breaks=zb, device="cpu", dtype=F64, **kw)
        assert (t._fes.k, t._fes.m, t._fes.n_phi) == (j._fes.k, j._fes.m, j._fes.n_phi)
        assert (t.GetNumGroups(), t.GetDimension()) == (j.GetNumGroups(), j.GetDimension())
    t = compat.NeutFEM(0, ng=2, x_breaks=xb, y_breaks=yb, z_breaks=zb, device="cpu")
    assert t._fes.P == 1
    with pytest.raises(TypeError):
        compat.NeutFEM(order=0, ng=2, x_breaks=xb, y_breaks=yb, device="cpu")


def test_the_card_is_the_default_device(monkeypatch):
    """No device argument means the card; without one the facade raises,
    never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xb = np.linspace(0.0, 4.0, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.NeutFEM(order=0, ng=2, x_breaks=xb, y_breaks=xb, z_breaks=[0.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BenchmarkRun(BENCHMARKS["iaea2d"], 1)
    assert compat.NeutFEM(0, 2, xb, xb, [0.0], device="cpu")._device.type == "cpu"


def test_getters_match_jax():
    j, t = _pair("iaea2d")
    for s in (j, t):
        assert s.get_flux_full() is None and s.get_flux_adj_full() is None
        assert not s.get_flux().any() and s.GetLastKeff() == 0.0
        assert s.GetLastOuterIterations() == 0 and s.GetLastIterations() == 0
        _solve(s)
    assert (t.GetNumGroups(), t.GetDimension(), t.GetNumElements()) == (2, 2, 38 * 38)
    assert abs(t.GetLastKeff() - j.GetLastKeff()) <= 1e-9
    assert t.GetLastOuterIterations() == j.GetLastOuterIterations()
    assert abs(t.GetLastInnerIterations() - j.GetLastInnerIterations()) <= 2
    assert t.GetLastIterations() == j.GetLastIterations()
    assert t.GetLastResidual() == pytest.approx(j.GetLastResidual(), rel=1e-6, abs=1e-12)
    assert 0.0 <= t.GetLastResidual() < 1e-5
    assert t.get_flux().shape == (2, 38, 38) and t.get_flux_full().shape == (2, 1, 38, 38)
    np.testing.assert_allclose(t.get_flux(), j.get_flux(), rtol=1e-7)
    assert t.get_SRC().shape == (2, 38, 38) and not t.get_SRC().any()
    t.get_SRC()[0, 3, 4] = 2.0  # a mutable view, as the reference's
    assert t._xs["SRC"][0, 0, 3, 4] == 2.0


def _robin_box(make):
    s = make(0, 2, np.linspace(0.0, 150.0, 16), np.linspace(0.0, 120.0, 13), np.array([0.0]))
    s.set_verbosity(0)
    for bid in (1, 2, 3, 4):
        s.set_bc(bid, compat.BCType.ROBIN)
    s.get_D()[0], s.get_D()[1] = 1.5, 0.4
    s.get_SigR()[0], s.get_SigR()[1] = 0.03, 0.08
    s.get_NSF()[0], s.get_NSF()[1] = 0.006, 0.12
    s.get_Chi()[0] = 1.0
    s.get_SigS()[1, 0] = 0.02
    s.BuildMatrices()
    return s


def test_robin_coefficients_match_jax():
    """A first solve at the default albedo, then ``set_robin_coefficients``
    and a cold solve: both facades move k alike."""
    out = []
    for make in (neutfem.NeutFEM, lambda *a: compat.NeutFEM(*a, device="cpu", dtype=F64)):
        s = _robin_box(make)
        k1 = _solve(s)[0]
        s.set_robin_coefficients(0.5, 2.0)
        s.reset_flux()
        out.append((k1, *_solve(s)))
    (k1j, kj, oj, _), (k1t, kt, ot, _) = out
    assert abs(k1t - k1j) <= 1e-9 and abs(kt - kj) <= 1e-9 and ot == oj
    assert abs(kt - k1t) > 1e-3  # the coefficients reached the rebuilt context


def test_verbose_lines_match_jax(capfd):
    lines = []
    for s in _pair("iaea2d"):
        s.set_verbosity(compat.VerbosityLevel.VERBOSE)
        capfd.readouterr()
        _solve(s)
        out = capfd.readouterr().out
        lines.append([ln.split() for ln in out.splitlines() if ln.startswith("  It ")])
    jl, tl = lines
    assert len(tl) == len(jl) > 3  # one line every 5 outers
    for j, t in zip(jl, tl):  # "It", i, ":", "k", "=", k, "dk", "=", dk, "dphi", ...
        assert t[:2] == j[:2] and t[-1] == j[-1]  # the outer index and its inners
        assert abs(float(t[5]) - float(j[5])) <= 2e-8


def test_profile_trace_is_written(tmp_path, monkeypatch):
    monkeypatch.setenv("NEUTFEM_PROFILE", str(tmp_path))
    s = compat.NeutFEM(0, 1, np.linspace(0.0, 200.0, 6), np.linspace(0.0, 200.0, 6), [0.0],
                       device="cpu", dtype=F64)
    s.set_verbosity(0)
    s.get_NSF()[...] = 0.011
    s.BuildMatrices()
    s.SolveKeff()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0


@pytest.fixture(scope="module")
def iaea2d_full():
    return _solve(BenchmarkRun(BENCHMARKS["iaea2d"], mesh_n=2, device="cpu", dtype=F64).solver)


@pytest.mark.parametrize("domain", ["quart_so", "moitie_s"])
def test_quarter_and_half_cores_match_jax(iaea2d_full, domain, monkeypatch):
    """The JAX facade solves a 19x38 half core in its own axis order (the
    port has no relabel): NEUTFEM_AXISPERM=0 keeps the user's, so both solve
    the same arithmetic."""
    monkeypatch.setenv("NEUTFEM_AXISPERM", "0")
    j, t = _pair("iaea2d", domain=domain)
    assert t.GetNumElements() == (19 * 19 if domain == "quart_so" else 19 * 38)
    if domain == "quart_so":
        assert t._sym_flags == ["quarter(0,1)"]
    (kj, oj, ij), (kt, ot, it) = _solve(j), _solve(t)
    assert abs(kt - kj) <= 1e-9
    assert ot == oj
    assert abs(it - ij) <= 2
    assert kt == pytest.approx(iaea2d_full[0], abs=5e-6)
