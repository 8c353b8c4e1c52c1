"""The import guard: a run may not load JAX or the JAX package. Modules
are compared by their whole top-level name (the part before the first
dot), so ``graph_wavenet_tpu_torch`` passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "graph_wavenet_tpu"})


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
