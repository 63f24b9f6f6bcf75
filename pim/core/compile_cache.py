"""Persistent XLA compilation cache for the heavy jitted programs.

The JAX persistent cache keys serialized executables by program hash, so
re-running bench/app/smoke after a restart skips straight to execution.
Analog of the reference's pipeline/renderpass caches
(src/rendering/vulkan/vkr_pipeline.c).

Where: JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself and
nothing here overrides it), otherwise `.jax_cache/` at the root of the
checkout (listed in .gitignore).  The path is part of the cache key, so it
is fixed rather than temporary.
"""

from __future__ import annotations

import os

_CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_DIR


def enable_compile_cache() -> str:
    """Idempotently enable the persistent compile cache; returns its dir."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)

    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    # cache anything that took real compile time; tiny programs recompile
    # faster than they deserialize
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return path
