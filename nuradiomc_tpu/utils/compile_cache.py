"""JAX's persistent compilation cache, in one place.

Every entry point (``chip_smoke.py``, ``bench.py``, ``__graft_entry__.py``,
``tools/*``, the test suite) calls :func:`enable` before its first compile, so
all processes of one checkout share compiled programs.

* If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at start-up and that
  directory is used; nothing here sets another.
* Otherwise the cache lives in ``<checkout>/.jax_cache``, derived from this
  file's location. The directory is part of the cache key, so it never
  depends on a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on and return its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # keep every program that takes half a second or more to compile: the
    # CPU test suite and a cold chip run are both dominated by compiles
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
