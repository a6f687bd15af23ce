"""Persistent compilation cache location, shared by the entry points
(chip_smoke.py, bench.py, the CLI).  The library import itself never
touches it."""
from __future__ import annotations

import os

#: The checkout's own cache directory (listed in .gitignore).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads that
    directory from the environment and nothing else is set here; otherwise
    the cache goes to ``.jax_cache/`` at the root of the checkout."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
