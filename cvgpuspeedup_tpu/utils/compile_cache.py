"""JAX's persistent compilation cache for this repository's scripts.

Importing the library sets nothing; ``chip_smoke.py``, ``bench.py`` and the
``benchmarks/`` scripts call :func:`enable_compile_cache` first thing.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: fixed cache location when the environment names none: the directory is
#: part of the cache key, so it must not move between runs
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already caches there and
    no directory is set in code; otherwise the cache goes to
    ``<repo>/.jax_cache``. Every compiled program is kept, however fast its
    compile: the programs here compile in about a second, under JAX's
    default threshold.
    """
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
