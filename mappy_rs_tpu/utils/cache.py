"""Persistent XLA compilation cache, shared by the entry-point scripts.

Library import never enables it; scripts (chip_smoke.py, bench.py,
__graft_entry__.py) call :func:`enable_compile_cache` once at start-up.
The directory is part of the cache key, so it is a fixed path: the
``JAX_COMPILATION_CACHE_DIR`` environment variable when it is set
(then no other directory is used), else ``<root>/.jax_cache`` inside
the caller's checkout.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(root: str) -> str:
    """The directory :func:`enable_compile_cache` would use."""
    return os.environ.get(ENV) or os.path.join(
        os.path.abspath(root), ".jax_cache"
    )


def enable_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    and return that directory.  Compiles that take at least a second
    are cached."""
    import jax

    path = cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
