"""JAX's persistent compilation cache, kept in one fixed place.

A compiled program is found again only under the same cache directory, so
the directory must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# The directory that holds the package (the checkout root for a source tree).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads the
    variable itself, so nothing is set here); otherwise the cache lives at
    :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
