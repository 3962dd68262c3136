"""JAX's persistent compile cache at a fixed path.

Programs that run the card (``chip_smoke.py``, ``bench.py`` and the
scripts) call :func:`enable_compile_cache` once at start-up, so a second
run of the same shapes skips XLA's compile. The path is part of what makes
the cache hit, so it never holds a temporary name, a process id or a time.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["cache_dir", "enable_compile_cache"]

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``<checkout>/.rad_tpu_cache/jax``."""
    return os.environ.get(ENV) or str(CHECKOUT / ".rad_tpu_cache" / "jax")


def enable_compile_cache() -> str:
    """Turn the cache on and return its directory. When the environment
    names a directory, JAX already reads it and no other is set here."""
    path = cache_dir()
    if ENV not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
