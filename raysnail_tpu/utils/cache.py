"""Where the persistent XLA compile cache lives.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
here. Otherwise the cache goes to `<repo>/.jax_cache`, one fixed path (it is
part of the cache key, so a path that moved with the working directory would
never hit)."""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO, ".jax_cache")
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; -> the directory it uses."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
