"""Persistent XLA compilation cache setup.

The codec's device programs take seconds to compile, and a process pays
that again unless JAX's persistent compilation cache is on.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
configures nothing.  Otherwise the cache lives at a fixed path inside the
checkout (``.jax_cache/``, git-ignored), so every process of one checkout
finds the programs the others compiled.  Entry points (``chip_smoke.py``,
``bench.py``) call enable_compile_cache() before their first jit.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Idempotently enable the persistent compilation cache; returns its
    directory.  Must run before the first jit compile to benefit it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(_DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return _DEFAULT_DIR
