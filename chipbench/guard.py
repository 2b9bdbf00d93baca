"""The import check: neither JAX nor the reference package may be loaded
where the benchmark runs.  Module names are compared by their top-level
name whole (the part before the first dot), so ``repro_torch`` is not
``repro``."""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})

__all__ = ["BANNED", "banned_modules"]


def banned_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in BANNED})
