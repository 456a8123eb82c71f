"""Persistent XLA compilation cache at a fixed place.

Full-grid SPE10 programs take long to compile, and a cold process pays
every compile again. JAX keeps compiled executables on disk when
`jax_compilation_cache_dir` is set; the directory is part of what makes a
hit, so it must not move between runs.

`enable_compile_cache()` leaves an explicit `JAX_COMPILATION_CACHE_DIR` to
JAX (which reads that variable itself) and otherwise points the cache at
`.jax_cache/` in the checkout root.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
