"""The CG block loop of ``neutfem_tpu_torch.krylov`` against the JAX package's
``lax.while_loop`` CGs, float64 on the CPU.

``pcg_blocks`` / ``pcg_fused_blocks`` run ``block`` iterations per host read,
each computing the ``while_loop``'s condition on the device and freezing the
state once it fails; on the card the same step is what the captured graph
replays (``tests/test_torch_gpu.py`` holds the two together).  Here the
eager loop at ``BLOCK_ITERS`` iterations a block, and ``pcg`` / ``pcg_fused``
(one a block on the CPU), meet the JAX ``pcg`` / ``pcg_fused`` with the same
iteration count, x within rel 1e-12 and the residual within 1e-12 at the
edges of the loop: a count the block does not divide, ``maxiter`` reached
inside a block, the tolerance met before the first iteration, a zero
right-hand side, a breakdown (p.Ap = 0) and a 0-d tensor tolerance.  Then:
one iteration a block and eight give the same bits, a frozen iteration
leaves x, r, rr and rz (gamma for ``pcg_fused``) bit for bit and every
tensor finite, and a group solve of IAEA-3D 1x1 gives the same bits through
the eager block loop as through ``group_solve``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neutfem_tpu.krylov import pcg as j_pcg, pcg_fused as j_pcg_fused
from neutfem_tpu_torch import krylov

F64 = torch.float64
N = 48


def _system(seed=0, n=N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    A = a @ a.T / n + np.diag(rng.uniform(0.5, 2.0, n))
    return A, rng.standard_normal(n), rng.standard_normal(n)


A0, B0, X00 = _system()
A_BRK = np.diag([2.0, 1.0] + [0.0] * (N - 2))  # e_last in its null space: p.Ap = 0
E_LAST = np.eye(N)[-1]

# name: (A, b, x0, tol, maxiter); 0-d tol: a tensor (torch) / array (JAX)
CASES = {
    "ragged": (A0, B0, X00, 1e-11, 1000),        # 26 / 23: no multiple of the block
    "maxiter_in_block": (A0, B0, X00, 1e-10, 13),
    "met_at_start": (A0, B0, X00, 1e3, 1000),
    "zero_rhs": (A0, np.zeros(N), X00, 1e-10, 1000),
    "breakdown": (A_BRK, E_LAST, np.zeros(N), 1e-10, 1000),
    "tensor_tol": (A0, B0, X00, "1e-8", 1000),
}
PRECONDS = ("none", "jacobi", "dots")


def _torch_ops(A, pc):
    At = torch.from_numpy(A)
    d = torch.from_numpy(np.diag(A).copy())
    minv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 1.0)
    precond = None if pc == "none" else (lambda r: minv * r)
    dots = None
    if pc == "dots":
        def dots(r):
            z = minv * r
            return z, torch.sum(r * z), torch.sum(r * r)
    return (lambda x: At @ x), precond, dots


def _jax_ops(A, pc):
    Aj = jnp.asarray(A)
    d = np.diag(A)
    minv = jnp.asarray(np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 1.0))
    return (lambda x: Aj @ x), (None if pc == "none" else (lambda r: minv * r))


def _tols(tol):
    if isinstance(tol, str):
        return torch.tensor(float(tol), dtype=F64), jnp.asarray(float(tol), dtype=jnp.float64)
    return tol, tol


def _close(got, want_x, want_it, want_res):
    x = np.asarray(want_x)
    assert got.iterations == int(want_it)
    scale = max(float(np.max(np.abs(x))), 1e-300)
    assert float(np.max(np.abs(got.x.numpy() - x))) <= 1e-12 * scale
    assert abs(float(got.residual) - float(want_res)) <= 1e-12


@pytest.mark.parametrize("pc", PRECONDS)
@pytest.mark.parametrize("case", list(CASES))
def test_pcg_blocks_match_jax(case, pc):
    A, b, x0, tol, maxiter = CASES[case]
    matvec, precond, dots = _torch_ops(A, pc)
    j_matvec, j_precond = _jax_ops(A, pc)
    t_tol, j_tol = _tols(tol)
    want = j_pcg(j_matvec, jnp.asarray(b), jnp.asarray(x0), precond=j_precond, tol=j_tol,
                 maxiter=maxiter)
    T = torch.from_numpy
    kw = {"precond": precond} if dots is None else {"precond_dots": dots}
    for got in (krylov.pcg_blocks(matvec, T(b), T(x0), tol=t_tol, maxiter=maxiter, **kw),
                krylov.pcg(matvec, T(b), T(x0), tol=t_tol, maxiter=maxiter, **kw)):
        _close(got, want.x, want.iterations, want.residual)
    if case == "ragged":
        assert got.iterations % krylov.BLOCK_ITERS != 0
    if case == "maxiter_in_block":
        assert got.iterations == maxiter and maxiter % krylov.BLOCK_ITERS != 0
    if case in ("met_at_start", "zero_rhs"):
        assert got.iterations == 0
    if case == "breakdown":
        assert got.iterations == 1


@pytest.mark.parametrize("pc", PRECONDS[:2])
@pytest.mark.parametrize("case", list(CASES))
def test_pcg_fused_blocks_match_jax(case, pc):
    A, b, x0, tol, maxiter = CASES[case]
    matvec, precond, _ = _torch_ops(A, pc)
    j_matvec, j_precond = _jax_ops(A, pc)
    t_tol, j_tol = _tols(tol)
    want = j_pcg_fused(j_matvec, jnp.asarray(b), jnp.asarray(x0), precond=j_precond, tol=j_tol,
                       maxiter=maxiter)
    T = torch.from_numpy
    for got in (krylov.pcg_fused_blocks(matvec, T(b), T(x0), precond=precond, tol=t_tol,
                                        maxiter=maxiter),
                krylov.pcg_fused(matvec, T(b), T(x0), precond=precond, tol=t_tol,
                                 maxiter=maxiter)):
        _close(got, want.x, want.iterations, want.residual)


@pytest.mark.parametrize("fused", [False, True])
def test_one_and_eight_iterations_a_block_give_the_same_bits(fused):
    matvec, precond, _ = _torch_ops(A0, "jacobi")
    T = torch.from_numpy
    run = krylov.pcg_fused_blocks if fused else krylov.pcg_blocks
    one, eight = (run(matvec, T(B0), T(X00), precond=precond, tol=1e-10, block=k)
                  for k in (1, 8))
    assert one.iterations == eight.iterations > 8
    assert torch.equal(one.x, eight.x) and torch.equal(one.residual, eight.residual)


@pytest.mark.parametrize("fused", [False, True])
def test_a_frozen_iteration_changes_nothing(fused):
    """Run the step until the stop test fails, then once more: x, r, rr and
    rz (gamma) keep their bits, the count stays, every tensor is finite."""
    matvec, precond, _ = _torch_ops(A0, "jacobi")
    T = torch.from_numpy
    if fused:
        st, step, *_ = krylov._fused_parts(matvec, precond, T(B0), T(X00), 1e-10, 1000)
        kept = ("x", "r", "rr", "gamma", "it", "go")
    else:
        st, step, *_ = krylov._pcg_parts(matvec, precond, None, T(B0), T(X00), 1e-10, 1000)
        kept = ("x", "r", "rr", "rz", "it", "go")
    while bool(st["go"]):
        st = step(st)
    assert int(st["it"]) > 0
    for _ in range(3):
        frozen = step(st)
        for name in kept:
            assert torch.equal(frozen[name], st[name]), name
        assert all(bool(torch.isfinite(t).all()) for t in frozen.values() if t.is_floating_point())
        st = frozen


def test_group_solve_bits_through_the_block_loop():
    """One group solve of IAEA-3D 1x1 RT0-P0 (float64): ``group_solve`` (one
    iteration a block on the CPU) and the plan's eager loop at eight a block
    give the same x and count."""
    from neutfem_tpu_torch.bench import BenchmarkRun
    from neutfem_tpu_torch.data import BENCHMARKS
    from neutfem_tpu_torch.power import SolveOptions, ctx_group, group_plan, group_solve

    run = BenchmarkRun(BENCHMARKS["iaea3d"], 1, 1, device="cpu",
                       dtype=F64)
    fes, ctx = run.solver._fes, run.solver._ctx
    ctxg = ctx_group(ctx, 0)
    rng = np.random.default_rng(4)
    rhs = torch.from_numpy(rng.standard_normal((1, *fes.mesh.shape)))
    opts = SolveOptions(inner_tol=1e-8)
    x0 = torch.zeros_like(rhs)
    ref = group_solve(fes, ctxg, opts, rhs, x0)
    plan = group_plan(fes, ctxg, opts, rhs)
    got = plan.blocks(plan.matvec, rhs * plan.sdi, x0 / plan.sdi, precond=plan.precond,
                      tol=opts.inner_tol, maxiter=opts.max_inner, block=8, **plan.kwargs())
    assert got.iterations == ref.iterations > 8
    assert ref.iterations % 8 != 0
    assert torch.equal(got.x * plan.sdi, ref.x)


def _launch_counts_in(module):
    """Per function of ``module`` that checks a kernel launch
    (``cuda_lib.check``): the line of that check and, for each
    ``tracing.count`` call, (its line, the literal head of the name it
    counts: the text before any placeholder)."""
    import ast
    import inspect

    out = {}
    for fn in ast.walk(ast.parse(inspect.getsource(module))):
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Attribute) and isinstance(c.func.value, ast.Name)]
        checks = [c.lineno for c in calls if (c.func.value.id, c.func.attr) == ("cuda_lib", "check")]
        if not checks:
            continue
        counts = []
        for c in calls:
            if (c.func.value.id, c.func.attr) == ("tracing", "count"):
                arg = c.args[0]
                if isinstance(arg, ast.JoinedStr):
                    arg = arg.values[0]
                counts.append((c.lineno, arg.value if isinstance(arg, ast.Constant) else None))
        out[fn.name] = (max(checks), counts)
    return out


def test_every_kernel_wrapper_counts_under_its_module_prefix():
    """Every function of a kernel module that launches a kernel counts the
    launch once, after the launch is checked, with ``tracing.count`` under
    its module's prefix ("fused.", "thomas.", ...), which ``bench``'s rows
    report (``bench.LAUNCH_PREFIXES``): the one counter registry a graph's
    capture takes back and its replays count again."""
    from neutfem_tpu_torch.bench import LAUNCH_PREFIXES
    from neutfem_tpu_torch.ops import blockjac, cgstep, fused, fused_eq, fused_ho, thomas

    for m in (fused, fused_eq, fused_ho, blockjac, thomas, cgstep):
        prefix = m.__name__.rsplit(".", 1)[1]
        assert prefix in LAUNCH_PREFIXES
        launches = _launch_counts_in(m)
        assert launches, m.__name__
        for name, (check, counts) in launches.items():
            assert len(counts) == 1, (m.__name__, name, counts)
            line, head = counts[0]
            assert line > check and head.startswith(prefix + "."), (m.__name__, name, head)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("stored", ["precond_blk_inv", "precond_blk_dev"])
def test_block_precond_on_a_refilled_copy_matches(stored, groups):
    """The block apply on a static copy that a ``CGPlans`` buffer holds,
    refilled from ``_block_source`` (the plan's path on the card), gives the
    bits of the apply on a copy made for it (one group's solve and the Jacobi
    sweep's batched one); the plans keep one buffer a shape."""
    from neutfem_tpu_torch.power import _block_precond, _block_source

    P, shape = 3, (2, 3, 4)
    rng = np.random.default_rng(7)
    lead = (groups,) if groups > 1 else ()
    ctxg = {stored: torch.as_tensor(rng.standard_normal((*lead, P, P, *shape)),
                                    dtype=torch.float32)}
    r = torch.from_numpy(rng.standard_normal((*lead, P, *shape)))
    plans = krylov.CGPlans()
    src = _block_source(ctxg)
    blks = plans.buffer(src.shape, F64, src.device)
    assert plans.buffer(src.shape, F64, src.device) is blks and len(plans.buffers) == 1
    apply = _block_precond(ctxg, F64, blks)
    blks.copy_(src)
    assert torch.equal(apply(r), _block_precond(ctxg, F64)(r))


def test_attach_twogrid_drops_the_plans():
    """A context's CG plans close over its two-grid level: attaching a new
    level forgets them (``krylov.drop_plans``)."""
    from neutfem_tpu_torch import mesh, twogrid
    from neutfem_tpu_torch.bc import BCKind, BCSpec
    from neutfem_tpu_torch.fespace import make_fespace
    from neutfem_tpu_torch.ops.context import build_context

    rng = np.random.default_rng(3)
    shape, ng = (1, 8, 8), 2
    xs = {"D": rng.uniform(0.3, 2.0, (ng, *shape)), "SigR": rng.uniform(0.01, 0.2, (ng, *shape)),
          "NSF": rng.uniform(0.0, 0.2, (ng, *shape)), "Chi": np.zeros((ng, *shape)),
          "SigS": np.zeros((ng, ng, *shape)), "SRC": np.zeros((ng, *shape))}
    xs["Chi"][0] = 1.0
    bcs = BCSpec()
    for ax in range(2):
        for up in (False, True):
            bcs.set(mesh.boundary_attribute(2, ax, up), BCKind.DIRICHLET)
    fes = make_fespace(mesh.CartesianMesh.from_breaks(np.arange(9.0), np.arange(9.0)), 0, 0)
    ctx = build_context(fes, ng, xs, bcs, device="cpu", dtype=F64)
    ctx[krylov.CG_PLANS] = krylov.CGPlans()
    twogrid.attach_twogrid(fes, ng, xs, bcs, ctx, factors=(2, 2, 1))
    assert "tg" in ctx and krylov.CG_PLANS not in ctx
