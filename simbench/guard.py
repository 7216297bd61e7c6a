"""The import check: the benchmark measures the PyTorch port and never
the JAX package beside it. Names are compared by their top-level part
(before the first dot) whole, since the port's name, ``repro_torch``,
begins with the JAX package's, ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
PORT = "repro_torch"


def top_levels(names) -> set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (by default the
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(top_levels(names) & FORBIDDEN)
