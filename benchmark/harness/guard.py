"""The import guard: a run may not load JAX or the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot), since the port's package name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sift_pyocl_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
