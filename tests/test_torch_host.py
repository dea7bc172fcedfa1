"""neutfem_tpu_torch host-side modules against neutfem_tpu, and its import hygiene.

The mesh, element tensors, FE space and the host LDL^T factorization are numpy
ports; they must reproduce the JAX package's arrays (rel <= 1e-14: the same
float64 arithmetic).  The port must never load JAX or the JAX packages.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from neutfem_tpu import elements as j_elements
from neutfem_tpu import fespace as j_fespace
from neutfem_tpu import mesh as j_mesh
from neutfem_tpu import native as j_native
from neutfem_tpu_torch import elements as t_elements
from neutfem_tpu_torch import fespace as t_fespace
from neutfem_tpu_torch import mesh as t_mesh
from neutfem_tpu_torch import native as t_native

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-14


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = np.max(np.abs(b)) if b.size else 0.0
    return float(np.max(np.abs(a - b)) / scale) if scale > 0 else float(np.max(np.abs(a - b), initial=0.0))


def _breaks(name):
    rng = np.random.default_rng(11)
    if name == "iaea3d_1x1":  # 19 assemblies of 20 cm per axis, one cell each
        b = np.linspace(0.0, 380.0, 20)
        return b, b, b
    if name == "nonuniform3d":
        return tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, n))])
                     for n in (9, 7, 5))
    # nonuniform 2D
    return (np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, 8))]),
            np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, 6))]), None)


MESHES = ["iaea3d_1x1", "nonuniform3d", "nonuniform2d"]


@pytest.mark.parametrize("name", MESHES)
def test_mesh_matches_jax(name):
    xb, yb, zb = _breaks(name)
    a = t_mesh.CartesianMesh.from_breaks(xb, yb, zb)
    b = j_mesh.CartesianMesh.from_breaks(xb, yb, zb)
    assert (a.dim, a.shape) == (b.dim, b.shape)
    for f in ("hx", "hy", "hz", "x_breaks", "y_breaks", "z_breaks"):
        assert _rel(getattr(a, f), getattr(b, f)) <= REL
    assert _rel(a.det_jac(), b.det_jac()) <= REL
    assert _rel(a.volumes(), b.volumes()) <= REL
    assert a.boundary_attrs() == b.boundary_attrs()
    for dim in (1, 2, 3):
        for ax in range(3):
            for up in (False, True):
                assert (t_mesh.boundary_attribute(dim, ax, up)
                        == j_mesh.boundary_attribute(dim, ax, up))


@pytest.mark.parametrize("name", MESHES)
def test_fespace_matches_jax(name):
    xb, yb, zb = _breaks(name)
    a = t_fespace.make_fespace(t_mesh.CartesianMesh.from_breaks(xb, yb, zb), 0, 0)
    b = j_fespace.make_fespace(j_mesh.CartesianMesh.from_breaks(xb, yb, zb), 0, 0)
    assert a.P == b.P and a.n_phi == b.n_phi and a.n_J == b.n_J
    assert np.array_equal(a.modes, b.modes)
    assert _rel(a.w_mode, b.w_mode) <= REL
    assert len(a.dirs) == len(b.dirs)
    for da, db in zip(a.dirs, b.dirs):
        assert (da.d, da.axis, da.T, da.face_shape) == (db.d, db.axis, db.T, db.face_shape)
        assert np.array_equal(da.p_to_t, db.p_to_t)
        for f in ("m_t", "BX", "BXc"):
            assert _rel(getattr(da, f), getattr(db, f)) <= REL


@pytest.mark.parametrize("k,m", [(0, 0), (1, 1), (2, 1)])
def test_element_tensors_match_jax(k, m):
    a, b = t_elements.element_tensors(k, m), j_elements.element_tensors(k, m)
    for f in ("M1", "M1_lumped", "D1", "leg_mass", "K", "G", "u_left", "u_right"):
        assert _rel(getattr(a, f), getattr(b, f)) <= REL


def test_tridiag_ldlt_batch_matches_jax():
    rng = np.random.default_rng(5)
    diag = rng.uniform(2.0, 3.0, (4, 7, 23))
    off = rng.uniform(-0.5, 0.5, (4, 7, 22))
    da, la = t_native.tridiag_ldlt_batch(diag, off)
    db, lb = j_native.tridiag_ldlt_batch(diag, off)
    assert _rel(da, db) <= REL and _rel(la, lb) <= REL


def test_port_imports_no_jax():
    """Importing every module of the port (its core data included) must not
    load JAX or any module of the JAX packages, by name or by file path: no
    loaded module may come from ``benchmarks/``, ``neutfem_tpu/`` or
    ``neutfem/``."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import neutfem_tpu_torch\n"
        "for m in pkgutil.walk_packages(neutfem_tpu_torch.__path__, 'neutfem_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import neutfem_tpu_torch.data\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'neutfem_tpu', 'neutfem', 'benchmarks'))\n"
        "assert 'neutfem_tpu_torch.bench' in sys.modules\n"
        "assert not bad, bad\n"
        f"repo = {str(REPO)!r}\n"
        "banned = tuple(os.path.join(repo, d) + os.sep for d in ('benchmarks', 'neutfem_tpu',\n"
        "                                                       'neutfem'))\n"
        "by_path = sorted(name for name, m in list(sys.modules.items())\n"
        "                 if os.path.abspath(getattr(m, '__file__', None) or '').startswith(banned))\n"
        "assert not by_path, by_path\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    """No source file of the port (nor the GPU smoke script, nor the card-only
    tests) names JAX or the JAX packages in an import."""
    banned = {"jax", "jaxlib", "neutfem_tpu", "neutfem", "benchmarks"}
    files = sorted((REPO / "neutfem_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py"]
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, f"{path.name} imports {n}"
