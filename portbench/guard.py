"""The whole-name check that a run loaded nothing of JAX or of the JAX package."""

from __future__ import annotations

from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

#: Top-level module names a run may not load: JAX and its libraries, the JAX
#: package, its reference-compatible API layer and its benchmark folder.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "neutfem_tpu", "neutfem", "benchmarks"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name (the part before the
    first dot) is, as a whole, one of ``FORBIDDEN``: ``neutfem_tpu_torch``
    passes, ``neutfem_tpu`` and ``jax.numpy`` do not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
