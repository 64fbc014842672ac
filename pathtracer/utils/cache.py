"""Where compiled programs are cached across processes.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, nothing here
overrides it. Otherwise the cache lives in `.jax_cache/` at the checkout
root — a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str | None:
    """The directory this program would set, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at `compile_cache_dir()`.

    The CPU backend is left without one: deserializing cached CPU
    executables has aborted long test processes. Returns the directory in
    effect (None on the CPU)."""
    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
