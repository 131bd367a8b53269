"""Persistent XLA compilation cache at one fixed place.

JAX keys cached executables by the cache directory among other things, so a
directory that moves between runs never hits. ``JAX_COMPILATION_CACHE_DIR``,
when set, wins: JAX reads it at start-up and nothing here overrides it.
Otherwise the cache lives at ``<checkout>/.jax_cache`` (listed in
``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return it. Call before the first compilation."""
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
