"""Persistent XLA compilation cache.

The LM solve is one large while_loop program; the persistent cache lets a
re-run load the compiled executable instead of compiling it again.
"""

from __future__ import annotations

import os

# fixed, gitignored path inside the checkout
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    no other directory is set here; otherwise the cache lives in
    ``<checkout>/.jax_cache``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
