"""Persistent XLA compilation cache, configured in one place.

Every distinct DP geometry is a fresh compile, so processes share
compiled executables through JAX's persistent cache.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no directory; otherwise the cache lives at ``<repo>/.jax_cache``
(listed in .gitignore).  The CLI, bench.py, chip_smoke.py and the test
suite all call ``enable_compile_cache``.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.config.jax_compilation_cache_dir
