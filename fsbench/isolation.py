"""The modules a run of the port's benchmark may not load."""

from __future__ import annotations

import sys

# Compared by whole top-level names: the port's package begins with the
# JAX package's name but is another module.
FORBIDDEN = ("jax", "jaxlib", "flax", "fluorosequencingimageanalysis_tpu")
PORT = "fluorosequencingimageanalysis_torch"


def loaded(names=FORBIDDEN, modules=None):
    """Sorted top-level module names of ``names`` present in ``modules``
    (default ``sys.modules``)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(tops & set(names))
