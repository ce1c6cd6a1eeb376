"""Persistent XLA compilation cache placement.

A cold receiver compiles a dozen programs (acquisition grids, scan and
fast tracking superblocks, tail shapes); the persistent cache keeps them
across processes. The cache path is part of its key, so it must not move
between runs: it is either what the deployment sets in
``JAX_COMPILATION_CACHE_DIR`` (which JAX reads itself) or the fixed
``.jax_cache`` directory of the checkout.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``, derived from the package's location."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed location and
    return that directory. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    already honours it and nothing is changed here."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
