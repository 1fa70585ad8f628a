"""Persistent XLA compile cache for the repository's entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at one fixed directory inside
the checkout, ``.jax_cache/`` (gitignored): the path is part of the cache
key, so a fixed path is what lets a later process find earlier compiles.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable(min_compile_secs: float = 0.5) -> str:
    """Turn the persistent cache on; returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
