"""Persistent compilation cache.

Every entry point (CLI, planck driver, serve, bench) and the MCEvidence
constructor call :func:`enable_compilation_cache`; it is idempotent.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing.  Otherwise accelerator compiles are cached at the fixed
``<checkout>/.jax_cache`` (git-ignored): the path is part of the cache key,
so it must not move between runs.  CPU compiles are not cached — a cached
CPU executable can carry machine features another host lacks.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    if jax.config.jax_compilation_cache_dir or jax.default_backend() == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    logger.debug("persistent compilation cache at %s", CACHE_DIR)


# ---------------------------------------------------------------------------
# compile-shape audit: every device dispatch path records its padded shape
# signature here.  Distinct entries correspond ~1:1 to distinct compiled XLA
# programs, each a compile per cold process, so the distinct-shape count is
# a first-class performance metric for a grid run.
# ---------------------------------------------------------------------------

_SHAPE_LOG: set = set()


def record_shape(tag: str, **dims) -> None:
    _SHAPE_LOG.add((tag, tuple(sorted(dims.items()))))


def shape_report() -> list:
    """Sorted human-readable audit lines, one per distinct program shape."""
    return sorted(
        "%s[%s]" % (tag, ", ".join(f"{k}={v}" for k, v in dims))
        for tag, dims in _SHAPE_LOG)


def reset_shape_log() -> None:
    _SHAPE_LOG.clear()
