"""The import guard: a run of the port loads nothing of JAX.

Each module's top-level name (the text before the first dot) is compared
whole: ``jrender_tpu_torch`` begins with ``jrender_tpu`` and is allowed.
"""
from __future__ import annotations

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'jrender_tpu')


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))
