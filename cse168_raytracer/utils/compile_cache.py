"""The one rule for JAX's persistent compile cache, shared by the CLI,
bench.py and chip_smoke.py: honour $JAX_COMPILATION_CACHE_DIR when it is
set (JAX reads it itself), else keep the cache in <checkout>/.jax_cache
(ignored by git). No other cache location is set in code."""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
