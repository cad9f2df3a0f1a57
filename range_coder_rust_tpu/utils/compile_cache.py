"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set in code.  Otherwise the cache goes to ``.jax_cache/`` at the root of
the checkout — a fixed path, because the path is part of the cache key
(a directory that moves never hits).  ``.gitignore`` lists it.
"""

from __future__ import annotations

import os

#: the checkout's root: the directory that holds the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
