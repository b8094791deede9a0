"""JAX's persistent compilation cache, at one fixed place per checkout."""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path, so every process of this checkout
# finds what an earlier one compiled (the path is part of the cache key).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache for this process.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``.
    The first bootstrap at production shapes compiles for tens of seconds;
    the cache cuts every later process start of the same checkout to a
    load.  Called by the entry scripts (bench.py, chip_smoke.py, the
    examples, tools/); library users opt in explicitly (a library must not
    write to disk on import).

    Returns the cache directory in use.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
