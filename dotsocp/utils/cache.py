"""Persistent XLA compilation cache helper.

Large while-loop graphs take seconds to minutes to compile; caching
compiled executables across processes makes bench, demo and smoke-test
reruns start hot. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets no directory; otherwise the cache sits at a
fixed, git-ignored path inside the checkout (the path is part of the
cache key, so a moving directory would never hit).
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on the persistent compile cache; returns the directory used."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
