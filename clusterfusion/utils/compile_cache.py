"""The one place the persistent JAX compilation cache is configured."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else at ``<checkout>/.jax_cache``.  Returns the path.

    The path is fixed: it is part of the cache key, so a directory that moves
    between runs never hits."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
