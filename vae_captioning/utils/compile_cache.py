"""Persistent XLA compilation cache, one switch for every entry point.

A fresh process compiles every program it runs; the persistent cache
lets the next process (the next benchmark, smoke run or CLI call) load
them instead.  JAX itself reads ``JAX_COMPILATION_CACHE_DIR``: when that
variable is set it names the only cache directory, and nothing here
overrides it.  Otherwise the cache lives at the fixed
``<checkout>/.jax_bench_cache`` — the path is part of what makes a later
run hit, so it does not move.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_bench_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = os.environ.get(ENV) or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
