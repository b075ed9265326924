"""Where the persistent XLA compilation cache lives.

JAX reads JAX_COMPILATION_CACHE_DIR itself: when the variable is set (an
empty value turns the cache off), nothing here changes it.  Otherwise the
cache goes to `.jax_cache/` at the root of the checkout (gitignored), a
fixed path, so a later process on the same machine finds its programs
again.  CPU-only runs (JAX_PLATFORMS=cpu) get no cache: cached CPU
executables depend on the host's CPU features, and one loaded on another
host can stall or die of SIGILL.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> None:
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return
    import jax
    if (jax.config.jax_platforms or "").lower().startswith("cpu"):
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
