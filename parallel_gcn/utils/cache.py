"""Persistent compilation cache location — one rule for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the program
sets no cache path. Otherwise the cache lives at the fixed
``<checkout>/.jax_cache``: the path is part of what makes a cache hit, so it
never derives from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
