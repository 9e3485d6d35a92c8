"""Where JAX keeps its persistent compilation cache.

Call ``configure_compile_cache()`` before ``jax`` is imported: JAX reads
``JAX_COMPILATION_CACHE_DIR`` when it initialises its configuration.
"""

from __future__ import annotations

import os

# the checkout root: two levels above this package's ``utils`` directory
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def configure_compile_cache() -> str:
    """Return the compile-cache directory, choosing one if none is set.

    A ``JAX_COMPILATION_CACHE_DIR`` already in the environment is used as
    it is and nothing else is set. Otherwise the cache goes to
    ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
    """
    cur = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cur:
        return cur
    path = os.path.join(_CHECKOUT, ".jax_cache")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    return path
