"""Where JAX keeps its persistent compilation cache.

Every entry point (``chip_smoke.py``, ``bench.py``, the scripts and the
test harness) calls :func:`configure` before it compiles anything.
"""

from __future__ import annotations

import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure(subdir: str = ".jax_cache") -> str:
    """Return the compile-cache directory in use, setting it if needed.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and
    nothing is changed.  Otherwise the cache goes to ``subdir`` of the
    checkout: a fixed path, so a later process finds what an earlier one
    compiled (the path is part of the cache's key).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
