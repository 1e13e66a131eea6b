"""Small shared helpers: the compile-cache setup and jit-safe array ops."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    The full pipeline takes minutes to compile cold.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no other
    directory is set here.  Otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout: a fixed path, since the path is part of what
    makes a later run find its entries."""
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(_REPO_ROOT, ".jax_cache")
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache


def topk_bounded(x: jnp.ndarray, k: int):
    """``lax.top_k`` that tolerates ``k`` larger than the axis size.

    Map stores can start smaller than the configured window sizes before
    auto-growth (map-length scaling, SURVEY §5.7): clamp ``k`` to the axis and
    pad values with 0 / indices with 0.  Callers must gate on ``value > 0``
    (every selection in this codebase does), so padded slots read as empty —
    do NOT re-gather weights through the padded indices.
    """
    n = x.shape[-1]
    kk = min(k, n)
    v, i = jax.lax.top_k(x, kk)
    if kk < k:
        pad = x.shape[:-1] + (k - kk,)
        v = jnp.concatenate([v, jnp.zeros(pad, v.dtype)], axis=-1)
        i = jnp.concatenate([i, jnp.zeros(pad, i.dtype)], axis=-1)
    return v, i
