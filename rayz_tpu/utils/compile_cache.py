"""Persistent XLA compilation cache at one fixed place.

Compiling the renderer takes seconds to minutes, and a fresh process would
pay it every run. JAX keys its cache on the directory too, so the directory
must not move between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is
set (JAX reads the variable itself) and ``<repo>/.jax_cache`` otherwise.
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "cache_dir", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on at :func:`cache_dir`; returns it."""
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
