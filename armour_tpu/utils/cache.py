"""Persistent JAX compilation cache.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set, and
otherwise at one fixed directory inside the checkout (`.jax_cache`, listed
in .gitignore): the path is part of what a later process looks up, so it
must not move between runs.
"""

import os
from pathlib import Path

import jax

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache() -> Path:
    """Point JAX's persistent compilation cache at cache_dir() and return it.

    Raises if the directory cannot be created or is not a directory, or if
    JAX refuses a setting."""
    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
