"""The masked PCG step of ``neutfem_tpu_torch.krylov`` through ``ops/cgstep``
against the inline step it replaced, on the CPU.

``krylov._pcg_parts``' step now computes its elementwise and 0-d work with
``cgstep.cg_xr`` / ``cgstep.cg_p``, which on a CPU tensor run their plain
versions.  Here one step of it meets the old inline expressions (written
out below as they stood in ``krylov.py``) bit for bit, in every entry of
the state, for the three preconditioner forms (none, ``precond``,
``precond_dots``), at float32 and float64, from a live state, a frozen one
(``go`` false), a breakdown (p.Ap = 0), a zero ``rz`` (read as 1) and an
iteration count reaching ``maxiter``.  The card tests
(``tests/test_torch_gpu.py``) hold the kernels to these plain versions.
"""

import numpy as np
import pytest
import torch

from neutfem_tpu_torch import bench, krylov, tracing
from neutfem_tpu_torch.ops import cgstep

N = 37  # no multiple of the kernels' 16-byte vectors
MAXITER = 9


def _old_step(matvec, apply, tiny, maxiter, st):
    """The inline step of ``krylov._pcg_parts`` before ``ops/cgstep``."""
    go, p, rz = st["go"], st["p"], st["rz"]
    q = matvec(p)
    pq = torch.sum(p * q)
    breakdown = torch.abs(pq) <= tiny
    ok = ~breakdown
    alpha = torch.where(go & ok, rz / torch.where(breakdown, 1.0, pq), 0.0)
    x = st["x"] + alpha * p
    r = st["r"] - alpha * q
    z, rz_new, rr_new = apply(r)
    beta = torch.where(go, rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
    it = st["it"] + go
    rr = torch.where(go, rr_new, st["rr"])
    return {"x": x, "r": r, "p": z + beta * p, "rr": rr, "rz": torch.where(go, rz_new, rz),
            "tol_sq": st["tol_sq"], "it": it,
            "go": go & ok & (rr > st["tol_sq"]) & (it < maxiter)}


def _operators(form, dtype, case, rng):
    a = rng.standard_normal((N, N))
    A = torch.as_tensor(a @ a.T / N + np.diag(rng.uniform(0.5, 2.0, N)), dtype=dtype)
    if case == "breakdown":
        A = torch.zeros_like(A)  # q = 0: p.Ap = 0
    minv = torch.as_tensor(rng.uniform(0.5, 2.0, N), dtype=dtype)
    matvec = lambda v: A @ v
    precond = (lambda r: minv * r) if form == "precond" else None
    precond_dots = None
    if form == "precond_dots":
        def precond_dots(r):
            z = minv * r
            return z, torch.sum(r * z), torch.sum(r * r)

    def apply(r):  # the old step's (z, <r, z>, <r, r>)
        if precond_dots is not None:
            return precond_dots(r)
        rr = torch.sum(r * r)
        if precond is None:
            return r, rr, rr
        z = precond(r)
        return z, torch.sum(r * z), rr

    return matvec, precond, precond_dots, apply


@pytest.mark.parametrize("case", ["live", "frozen", "breakdown", "rz_zero", "maxiter"])
@pytest.mark.parametrize("form", ["none", "precond", "precond_dots"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cgstep_plain_reproduces_the_inline_step(dtype, form, case):
    """One step through ``ops/cgstep``'s plain versions equals the old inline
    step in every entry of the state, bit for bit."""
    rng = np.random.default_rng(11)
    matvec, precond, precond_dots, apply = _operators(form, dtype, case, rng)
    t = lambda: torch.as_tensor(rng.standard_normal(N), dtype=dtype)
    s = lambda v: torch.tensor(v, dtype=dtype)
    rhs = t()
    _, step, _, _ = krylov._pcg_parts(matvec, precond, precond_dots, rhs, t(), 1e-6, MAXITER)
    st = {"x": t(), "r": t(), "p": t(), "rr": s(rng.uniform(0.5, 1.0)),
          "rz": s(0.0 if case == "rz_zero" else rng.uniform(0.5, 1.0)),
          "tol_sq": s(1e-12), "it": torch.tensor(MAXITER - 1 if case == "maxiter" else 3,
                                                  dtype=torch.int32),
          "go": torch.tensor(case != "frozen")}
    want = _old_step(matvec, apply, torch.finfo(dtype).tiny, MAXITER, dict(st))
    got = step(dict(st))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert bool(want["go"]) == (case in ("live", "rz_zero"))
    if case == "maxiter":
        assert int(want["it"]) == MAXITER


def test_cgstep_plain_on_the_cpu_launches_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    rng = np.random.default_rng(12)
    v = [torch.from_numpy(rng.standard_normal(N)) for _ in range(4)]
    s = [torch.tensor(float(x)) for x in rng.uniform(0.5, 1.0, 5)]
    with tracing.collect() as c:
        x, r, r2 = cgstep.cg_xr(*v, s[0], s[1], torch.tensor(True))
        assert torch.equal(r2, r * r)
        assert cgstep.cg_xr(*v, s[0], s[1], torch.tensor(True), rr=False)[2] is None
        cgstep.cg_p(v[0], v[1], s[0], s[1], s[2], s[3], s[4],
                    torch.tensor(0, dtype=torch.int32), torch.tensor(True),
                    torch.tensor(1e-12), 5)
    assert not [k for k in c.record["counters"] if k.startswith("cgstep.")]


def test_cgstep_counts_under_its_tracing_prefix():
    """``cg_xr`` and ``cg_p`` count a launch as ``tracing``'s
    ``cgstep.cg_xr`` / ``cgstep.cg_p`` once the launch is checked, and a
    bench row reports those counters under the bare keys "cg_xr" / "cg_p"."""
    import inspect

    for name in ("cg_xr", "cg_p"):
        src = inspect.getsource(getattr(cgstep, name))
        assert src.index(f'tracing.count("cgstep.{name}")') > src.index("cuda_lib.check(")
    before = bench.launch_counts()
    tracing.count("cgstep.cg_xr", 2)
    tracing.count("cgstep.cg_p")
    try:
        assert bench._launches_since(before) == {"cg_xr": 2, "cg_p": 1}
    finally:
        tracing.count("cgstep.cg_xr", -2)
        tracing.count("cgstep.cg_p", -1)
