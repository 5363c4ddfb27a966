"""The check that no process of a run has loaded JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: `ucoslam_tpu_torch` is the port, `ucoslam_tpu` the JAX
package.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ucoslam_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names in `modules` (default: sys.modules) that are
    forbidden."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
