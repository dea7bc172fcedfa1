"""neutfem_tpu_torch — PyTorch/CUDA port of neutfem_tpu for NVIDIA Hopper GPUs.

The multigroup k-effective solve of the mixed finite-element neutron diffusion
framework, RT0-P0 and RT_k-P_k, 2D and 3D: structured mesh, operator context,
matrix-free Schur complement with hand-written CUDA kernels for the fused
per-direction Schur products (RT0 and the condensed higher-order form) and the
batched Thomas solves (``csrc/``), Jacobi-equilibrated CG with the
block-Jacobi (k >= 1), line-tridiagonal or additive two-grid preconditioner,
and the Chebyshev-accelerated power iteration, behind the
reference-compatible ``compat.NeutFEM`` facade.  The JAX package ``neutfem_tpu`` is the reference it
is tested against; this package never imports JAX.
"""

from . import config  # noqa: F401  — dtype and TF32 pins first

from .bc import BCKind, BCSpec  # noqa: E402
from .fespace import FESpace, make_fespace  # noqa: E402
from .mesh import CartesianMesh  # noqa: E402

__all__ = ["CartesianMesh", "BCKind", "BCSpec", "FESpace", "make_fespace", "config"]
