"""Boundary-condition specification (port of ``neutfem_tpu/bc.py``).

* DIRICHLET: Marshak vacuum ``phi_b = 2 (J.n)`` — adds ``2 * G_ff`` to the boundary-face
  diagonal of A (``marshak_d_factor=True`` multiplies the reference's extra ``D``,
  NeutFEM.cpp:1350, for eigenvalue parity).
* MIRROR: reflective condition ``J.n = 0`` — the boundary-face DOFs are pinned to zero.
* NEUMANN(value=q): prescribed inward current density q; q = 0 is MIRROR.  Nonzero q
  is an inhomogeneous essential condition, lifted as J = J' + J_q with a fixed
  flux-space source (``src_bc``) the fixed-source solves add and a current
  correction (``jcorr``) added to the output current; the reference accepts the
  value and ignores it (wrapper.cpp:401-423).
* ROBIN(alpha, beta): albedo ``phi_b = (beta / (alpha * D)) (J.n)``.
* PERIODIC: true periodic coupling, set on BOTH ends of a direction — the face system
  along it becomes cyclic tridiagonal, solved exactly by Sherman-Morrison on the
  LDL^T factors (``ops/context.py``); B / B^T and CMFD wrap around.  The reference
  never discretizes it (NeutFEM.cpp:2128-2131); ``build_context(...,
  periodic_natural=True)`` gives that parity (a warning, then a natural boundary).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict


class BCKind(enum.IntEnum):
    # Values match the reference BCType declaration order (NeutFEM.hpp:51-57).
    DIRICHLET = 0
    NEUMANN = 1
    MIRROR = 2
    ROBIN = 3
    PERIODIC = 4
    NONE = 99  # unspecified: natural (zero boundary flux), the reference default


@dataclasses.dataclass
class BCSpec:
    """BCs keyed by boundary attribute (mesh.boundary_attribute numbering)."""

    kinds: Dict[int, BCKind] = dataclasses.field(default_factory=dict)
    values: Dict[int, float] = dataclasses.field(default_factory=dict)
    robin_alpha: float = 1.0
    robin_beta: float = 1.0

    def set(self, attr: int, kind: BCKind, value: float = 0.0):
        self.kinds[int(attr)] = BCKind(int(kind))
        self.values[int(attr)] = float(value)

    def kind(self, attr: int) -> BCKind:
        return self.kinds.get(int(attr), BCKind.NONE)

    def value(self, attr: int) -> float:
        return self.values.get(int(attr), 0.0)
