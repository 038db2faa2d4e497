"""The run's guard against the JAX package: the port is measured alone."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "biograph_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: ``biograph_tpu_torch`` is not
    ``biograph_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
