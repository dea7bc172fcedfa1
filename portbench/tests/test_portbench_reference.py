"""The check that decides ``correct``, rehearsed on the CPU at a tiny mesh of
each configuration through the real entry point (``run.run_cell``): the
program's answer passes, the bfloat16 control fails, and so does each fault
a cold solve can have, planted under the timed path.  And the reference
imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.inputs import build_inputs
from portbench.rehearse import rehearse

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SEED = 3000000019
REF = os.path.join(manifest.ROOT, "portbench", "reference")
ALLOWED = {"__future__", "dataclasses", "itertools", "typing", "numpy"}


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    r = rehearse(cell, SEED)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell):
    r = rehearse(cell, SEED + 1, control="bf16")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name,mesh", [
    ("iaea3d-rt0p0-6x6x4", {"per_assembly": 1, "per_plane": 1}),
    ("iaea3d-rt2p2-4x4x2", {"per_assembly": 1, "per_plane": 1}),
    ("zion2d-rt0p0-48x48", {"per_assembly": 4}),
])
def test_fick_solve_inverts_the_current_mass(name, mesh):
    """The reference's Fick solve is exact: A_d applied to its answer gives
    back the right-hand side, in every direction and group."""
    import numpy as np

    from portbench.reference.check import Operators

    cfg = {**_config(name), "mesh": mesh}
    ops = Operators(build_inputs(cfg, 7, {"xs_sample": {"rel_sigma": 0.001, "clip": 3.0}}),
                    cfg["discretization"]["rt_order"])
    rng = np.random.default_rng(7)
    phi = rng.random((ops.ng,) + ops.D.shape[1:] + (ops.space.P,))
    for di in ops.space.dirs:
        for g in range(ops.ng):
            rF, rW = ops.BT(di, phi[g:g + 1])
            rW = rW[0] if rW is not None else None
            F, W = ops.fick_solve(di, g, rF[0], rW)
            AF, AW = ops.A(di, g, F, W)
            np.testing.assert_allclose(AF, rF[0], rtol=0, atol=1e-12 * np.abs(rF).max())
            if rW is not None:
                np.testing.assert_allclose(AW, rW, rtol=0, atol=1e-12 * np.abs(rW).max())


@pytest.mark.parametrize("name,mesh", [
    ("iaea3d-rt0p0-6x6x4", {"per_assembly": 1, "per_plane": 1}),
    ("zion2d-rt0p0-48x48", {"per_assembly": 4}),
])
def test_control_differs_only_in_the_flux_precision(name, mesh):
    """The bfloat16 control is a consistent answer: its current is Fick's law
    of its flux and its k the Rayleigh quotient, so only the balance, which
    the flux's precision sets, can fail."""
    import numpy as np

    from portbench.reference.check import Operators, bfloat16_control, judge, round_to_bfloat16

    cfg = {**_config(name), "mesh": mesh}
    ops = Operators(build_inputs(cfg, 8, {"xs_sample": {"rel_sigma": 0.001, "clip": 3.0}}),
                    cfg["discretization"]["rt_order"])
    phi = 1.0 + np.random.default_rng(8).random((ops.ng,) + ops.D.shape[1:] + (ops.space.P,))
    k, phi_b, J = bfloat16_control(ops, phi)
    np.testing.assert_array_equal(phi_b, round_to_bfloat16(phi))
    r = judge(ops, k, phi_b, J)
    assert r["fick_res"] < 1e-12 and r["k_gap"] < 1e-12, r


def _config(name):
    with open(os.path.join(manifest.ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _fault(monkeypatch, kind, limits):
    from neutfem_tpu_torch.compat import NeutFEM

    real = NeutFEM.SolveKeff

    def broken(self, *a, **kw):
        k = real(self, *a, **kw)
        if kind == "unchanged":  # the flat start flux and k0 = 1 handed back
            self._phi = self._flat_phi()
            self._J = {key: {p: t * 0 for p, t in e.items()} for key, e in self._J.items()}
            k = 1.0
        elif kind == "k_altered":
            k = k * (1.0 + 10.0 * limits["k_gap"]["limit"])
        elif kind == "flux_altered":  # one group's flux off by 1%
            self._phi = self._phi.clone()
            self._phi[0] *= 1.01
        elif kind == "group_left_out":  # half of the groups left unsolved
            self._phi = self._phi.clone()
            self._phi[-1] = 0.0
        self._keff = k
        return k

    monkeypatch.setattr(NeutFEM, "SolveKeff", broken)


KINDS = ["unchanged", "k_altered", "flux_altered", "group_left_out"]


@pytest.mark.parametrize("cell,kind", [(c, k) for c in CELLS for k in KINDS
                                       # RT2-P2's CPU solve takes minutes: one fault there
                                       if "rt2p2" not in c or k == "unchanged"])
def test_a_broken_solve_is_not_correct(monkeypatch, cell, kind):
    _fault(monkeypatch, kind, manifest.load_cell(cell).limits)
    r = rehearse(cell, SEED + 2)
    assert not r["correct"], (kind, r["checks"])


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: the reference's own modules
                    continue
                mods = [node.module]
            else:
                continue
            assert all(m.split(".")[0] in ALLOWED for m in mods), (name, mods)
    code = ("import sys, portbench.reference.check; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('neutfem_tpu_torch', 'neutfem_tpu', 'neutfem', 'jax', 'torch')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_inputs_equal_the_programs_benchmark_arrays():
    """At a zero cross-section sample, the frozen input code gives the arrays the
    program's ``BenchmarkRun`` fills (its copy of the same arithmetic)."""
    import numpy as np
    import torch

    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS

    for name, core, n, nz in (("iaea3d-rt0p0-6x6x4", "iaea3d", 1, 1),
                              ("zion2d-rt0p0-48x48", "zion2d", 4, 1)):
        with open(os.path.join(manifest.ROOT, "portbench", "configs", name + ".json")) as f:
            cfg = json.load(f)
        cfg["mesh"] = {"per_assembly": n, "per_plane": nz}
        inp = build_inputs(cfg, 1, {"xs_sample": {"rel_sigma": 0.0, "clip": 3.0}})
        run = BenchmarkRun(BENCHMARKS[core], mesh_n=n, mesh_nz=nz, device="cpu",
                           dtype=torch.float64)
        s = run.solver
        sq = (lambda a: a[..., 0, :, :]) if inp.dim == 2 else (lambda a: a)
        for key, getter in (("D", s.get_D), ("SigR", s.get_SigR), ("NSF", s.get_NSF),
                            ("Chi", s.get_Chi), ("SigS", s.get_SigS)):
            np.testing.assert_array_equal(sq(inp.xs[key]), getter(), err_msg=f"{name} {key}")


def test_sample_is_seeded():
    import numpy as np

    cfg = manifest.load_cell(CELLS[0]).config
    t = manifest.load_cell(CELLS[0]).traffic
    a = build_inputs({**cfg, "mesh": {"per_assembly": 1, "per_plane": 1}}, 2**31 + 5, t)
    b = build_inputs({**cfg, "mesh": {"per_assembly": 1, "per_plane": 1}}, 2**31 + 5, t)
    c = build_inputs({**cfg, "mesh": {"per_assembly": 1, "per_plane": 1}}, 2**31 + 6, t)
    np.testing.assert_array_equal(a.xs["D"], b.xs["D"])
    assert not np.array_equal(a.xs["D"], c.xs["D"])
    void = a.xs["SigR"] > 1e14  # IAEA-3D's numerical void is kept as published
    assert np.all(a.xs["SigR"][void] == 1e15)
