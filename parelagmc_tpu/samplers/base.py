"""Abstract multilevel sampler contract.

Batched JAX analog of the reference's MLSampler interface
(/root/reference/src/MLSampler.hpp:22-91): a sampler produces batches of
white noise per level (`sample`) and maps noise to random-field
realizations on a target level (`eval`), where the noise may live on a
finer level than the field (the MLMC coupling: the reference restricts the
white-noise rhs through Ps^T, src/PDESampler.cpp:361-368).

Differences from the reference, by design:
* Everything is batched: noise has shape (batch, n) and eval maps batches.
* RNG is counter-based (jax.random keys folded with (level, batch index))
  instead of TRNG leapfrog streams (src/NormalDistributionSampler.cpp:21-24):
  reproducible regardless of device count or batch size.
* eval() is a pure function suitable for jit/vmap/shard_map composition by
  the managers; samplers hold only static operator pytrees.
* Warm-starting (`use_init` in the reference's Eval overloads) is obsolete:
  the tensor-grid path solves directly, so coupled pair evaluations are
  exact without iteration seeding.
"""

from __future__ import annotations

import abc
from typing import Optional

import jax.numpy as jnp


class MLSampler(abc.ABC):
    @abc.abstractmethod
    def sample_size(self, level: int) -> int:
        """Noise vector length at `level` (reference: MLSampler::SampleSize)."""

    @abc.abstractmethod
    def field_size(self, level: int) -> int:
        """Realization (cell field) length at `level` on the original mesh."""

    @abc.abstractmethod
    def sample(self, level: int, key, nsamples: int) -> jnp.ndarray:
        """Draw (nsamples, sample_size(level)) white noise."""

    @abc.abstractmethod
    def eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        """Map noise sampled at `xi_level` (default `level`) to realizations
        on `level`. xi_level <= level (noise restricted to coarser levels for
        MLMC coupling)."""

    def nnz(self, level: int) -> int:
        """Operator size metric for the ShowMe dashboards."""
        return 0
