"""JAX's persistent compilation cache at a fixed path.

The cache key includes the cache directory, so the path must not move between
runs: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself), and
otherwise ``<checkout>/.jax_cache``, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the cache on (before the first compile) and return its path."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
