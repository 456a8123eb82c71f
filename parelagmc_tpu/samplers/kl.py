"""Truncated Karhunen-Loeve expansion sampler.

Batched JAX analog of the reference's KLSampler
(/root/reference/src/KLSampler.cpp): given covariance eigenpairs
(theta_k, b_k) on the finest level, a realization is

    s(level) = sum_k sqrt(theta_k) * b_k(level) * xi_k,    xi ~ N(0, sigma^2),

with the eigenvectors carried to coarser levels by the P0 cochain
projector (volume-weighted averaging over agglomerates,
Pi = W_c^{-1} P_l2^T W_f - the reference applies ParELAG's GetPi
projector per level, KLSampler.cpp:172-190), and exp() for log-normal
fields.

On device the evaluation is one dense matmul (batch, modes) x (modes, n)
per level - one dense matmul. MLMC coupling needs no restriction: fine and
coarse realizations share the same mode coefficients xi (the reference's
Eval uses the same xi at every level).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import GeometricHierarchy
from parelagmc_tpu.samplers.base import MLSampler
from parelagmc_tpu.samplers.covariance import CovarianceFunction


class KLSampler(MLSampler):
    def __init__(
        self,
        hierarchy: GeometricHierarchy,
        covariance: CovarianceFunction,
        config: ProblemConfig,
        dtype=jnp.float32,
    ):
        self.hierarchy = hierarchy
        self.covariance = covariance
        self.config = config
        self.dtype = dtype
        self.sigma = float(np.sqrt(config.variance))
        self.lognormal = bool(config.lognormal)
        if covariance.num_modes == 0:
            covariance.solve_eigenvalue()
        theta = covariance.eigenvalues
        self.nmodes = theta.shape[0]
        self.sqrt_theta = jnp.asarray(np.sqrt(np.maximum(theta, 0.0)), dtype=dtype)
        # Per-level mode matrices: scaled eigenvectors, coarsened by the
        # volume-weighted cochain projector.
        evs: List[np.ndarray] = [covariance.eigenvectors]
        for l in range(hierarchy.nlevels - 1):
            Wf = hierarchy.levels[l].W
            Wc = hierarchy.levels[l + 1].W
            fine = evs[l]
            coarse = np.zeros((hierarchy.levels[l + 1].n_s, self.nmodes))
            np.add.at(coarse, hierarchy.parent[l], Wf[:, None] * fine)
            coarse /= Wc[:, None]
            evs.append(coarse)
        self.modes = [jnp.asarray(e.T, dtype=dtype) for e in evs]  # (modes, n_l)

    def sample_size(self, level: int) -> int:
        return self.nmodes

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key, nsamples: int) -> jnp.ndarray:
        from parelagmc_tpu.ops.prng import sample_normals

        return self.sigma * sample_normals(
            key, (nsamples, self.nmodes), dtype=self.dtype
        )

    def eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        # xi_level is irrelevant: modes are shared across levels.
        # HIGHEST: DEFAULT float32 precision may run in TF32 on the GPU.
        s = jnp.matmul(
            xi * self.sqrt_theta, self.modes[level],
            precision=lax.Precision.HIGHEST,
        )
        return jnp.exp(s) if self.lognormal else s

    def nnz(self, level: int) -> int:
        return int(self.modes[level].size)
