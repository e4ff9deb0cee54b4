"""Where JAX keeps its persistent compile cache — decided in one place.

Every launcher (bench.py, bench_scaling.py, chip_smoke.py, the CLI) calls
``enable_compile_cache()`` before its first compilation. If the
``JAX_COMPILATION_CACHE_DIR`` environment variable is set, JAX reads it
itself and nothing is set here. Otherwise the cache lives at a fixed path
inside the checkout (``.jax_cache/``, listed in .gitignore): the path is
part of the cache key, so a directory that moved would never hit.

Imports nothing from jax at module level.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns it."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
