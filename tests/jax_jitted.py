"""The JAX package's solves as the port's parity tests call them: each one
compiled whole with ``jax.jit``, as the package's facade compiles its power
iteration (``neutfem/_neutfem_eigen.py``, ``_solver_fn``).

Called eagerly, a JAX solve compiles its ``while_loop`` and then every
operation around it one by one: hundreds of small XLA compiles a problem,
most of a parity test's time on the CPU.  Compiled whole it is one compile
and the same computation (XLA fuses the operations; the results move by a few
units in the last place, far inside the tests' tolerances).  The functions
take and return what the package's functions do; options, flags and Python
scalars other than the start eigenvalue are fixed at compile time.
"""

from __future__ import annotations

import functools

import jax

from neutfem_tpu import power as _power
from neutfem_tpu.ops import apply as _apply


def power_iteration(fes, ng, opts, ctx, phi0, keff0, adjoint=False, fixed_keff=None):
    """``neutfem_tpu.power.power_iteration``, compiled whole."""
    fn = jax.jit(functools.partial(_power.power_iteration, fes, ng, opts, adjoint=adjoint,
                                   fixed_keff=fixed_keff))
    return fn(ctx, phi0, keff0)


def fixed_source_solve(fes, ng, opts, ctx, phi0, with_fission=True, keff=1.0):
    """``neutfem_tpu.power.fixed_source_solve``, compiled whole."""
    fn = jax.jit(functools.partial(_power.fixed_source_solve, fes, ng, opts,
                                   with_fission=with_fission, keff=keff))
    return fn(ctx, phi0)


def solve_subcritical(fes, ng, opts, ctx, phi0, keff=1.0):
    """``neutfem_tpu.power.solve_subcritical``, compiled whole."""
    fn = jax.jit(functools.partial(_power.solve_subcritical, fes, ng, opts, keff=keff))
    return fn(ctx, phi0)


def group_solve(fes, ctxg, opts, rhs, x0):
    """``neutfem_tpu.power.group_solve``, compiled whole."""
    return jax.jit(functools.partial(_power.group_solve, fes, opts=opts))(ctxg, rhs=rhs, x0=x0)


def schur_matvec(fes, ctx, v, a_mode="exact", **kw):
    """``neutfem_tpu.ops.apply.schur_matvec``, compiled whole."""
    return jax.jit(functools.partial(_apply.schur_matvec, fes, a_mode=a_mode, **kw))(ctx, v)


def dense_schur_group(fes, ctxg, a_mode="exact"):
    """``neutfem_tpu.ops.direct.dense_schur_group``, compiled whole."""
    from neutfem_tpu.ops import direct

    return jax.jit(functools.partial(direct.dense_schur_group, fes, a_mode=a_mode))(ctxg)


def twogrid_correction(fes, ctxg, opts, r):
    """``neutfem_tpu.twogrid.twogrid_correction``, compiled whole."""
    from neutfem_tpu import twogrid

    return jax.jit(functools.partial(twogrid.twogrid_correction, fes, opts=opts))(ctxg, r=r)
