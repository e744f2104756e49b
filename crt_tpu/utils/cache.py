"""Persistent XLA compilation cache.

First compilation of the full render program costs tens of seconds.  With
the persistent cache, every CLI / bench process after the first reuses
compiled executables from disk.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and this module sets nothing; otherwise the cache lives
at the fixed ``<checkout>/.jax_cache`` (a fixed path, because the directory
is part of the cache key).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
