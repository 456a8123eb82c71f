"""Noise for the samplers: N(0,1) and U[0,1) draws from jax.random.

The stream is fully determined by the jax.random key; samplers fold
(level, batch counter) into the key, and sharded managers fold the device
index, so runs are reproducible for a fixed device count - the replacement
for the reference's TRNG leapfrog streams
(src/NormalDistributionSampler.cpp:21-24). XLA compiles the counter-based
threefry generator into fused elementwise kernels.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def sample_normals(key, shape: Tuple[int, ...], dtype=jnp.float32) -> jnp.ndarray:
    """N(0,1) samples of `shape`, deterministic in `key`."""
    return jax.random.normal(key, shape, dtype=dtype)


def sample_uniforms(key, shape: Tuple[int, ...], dtype=jnp.float32) -> jnp.ndarray:
    """U[0,1) samples of `shape` - the analog of the reference's
    UniformDistributionSampler (src/UniformDistributionSampler.hpp:27-64)."""
    return jax.random.uniform(key, shape, dtype=dtype)
