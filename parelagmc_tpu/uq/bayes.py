"""Bayesian inverse problem: parameter-to-observable map and likelihoods.

Batched JAX analog of the reference's BayesianInverseProblem
(/root/reference/src/BayesianInverseProblem.cpp): posterior expectations of
a QoI are computed as ratios of *prior* expectations,

    E_post[Q] = E[Q * Pi(u)] / E[Pi(u)] = E[R] / E[Z],

with the Gaussian likelihood Pi(u) = exp(-|G(u) - y|^2 / (2*noise)) of the
parameter-to-observable map G. Observables (reference :44-104):

* m == 0: G = (int_D p) / |D| - the normalized pressure integral.
* m > 0:  G_i = local average pressure over the cells within eps of the
  i-th observation coordinate, G_i = <g_i, p> / sum(g_i).

All maps are batched and jit-compatible: compute_G / likelihood /
compute_R take (batch, n_s) coefficient fields and return per-sample
values; the manager composes them with the prior sampler into fused level
steps. Synthetic reference data y = G(u_ref) + N(0, noise) is generated
from one prior draw or loaded from file (reference :125-176).
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.physics.darcy import DarcySolver
from parelagmc_tpu.samplers.base import MLSampler


class BayesianInverseProblem:
    def __init__(
        self,
        solver: DarcySolver,
        prior: MLSampler,
        config: ProblemConfig,
        dtype=jnp.float32,
    ):
        self.solver = solver
        self.prior = prior
        self.config = config
        self.dtype = dtype
        self.noise = float(config.bayes_noise)
        self.m = int(config.bayes_num_obs)
        hierarchy = solver.hierarchy
        self.nlevels = hierarchy.nlevels
        d = hierarchy.levels[0].dim

        # Observation functionals on the pressure space, finest level, then
        # restricted through P_l2^T.
        fine = hierarchy.levels[0]
        n_obs = max(self.m, 1)
        g0 = np.zeros((n_obs, fine.n_s))
        if self.m == 0:
            g0[0] = fine.W
        else:
            coords = np.asarray(config.bayes_obs_coords, dtype=np.float64).reshape(
                self.m, d
            )
            centers = fine.mesh.cell_centers()
            for i in range(self.m):
                mask = (
                    np.abs(centers - coords[i][None, :]).max(axis=1)
                    <= config.bayes_eps
                )
                if not mask.any():
                    raise ValueError(
                        f"no cells within eps={config.bayes_eps} of obs point {i}"
                    )
                g0[i] = np.where(mask, fine.W, 0.0)
        gs: List[np.ndarray] = [g0]
        for l in range(self.nlevels - 1):
            # Sparse restriction g_{l+1} = g_l P: P.toarray() would be a
            # dense (n_fine, n_coarse) materialization - ~600 GB at SPE10
            # scale (round-5 fix; reference restricts through hypre SpMV,
            # BayesianInverseProblem.cpp:44-104).
            P_l2 = hierarchy.p_l2(l)
            gs.append(np.asarray((P_l2.T @ gs[l].T).T))
        # Normalized functionals: G_i = <g_i, p> / sum(g_i).
        self.g_obs = [
            jnp.asarray(g / g.sum(axis=1, keepdims=True), dtype=dtype) for g in gs
        ]
        self.G_obs: Optional[jnp.ndarray] = None  # (n_obs,)

    @property
    def size_obs_data(self) -> int:
        return max(self.m, 1)

    # -- observable / likelihood maps (batched, jit-safe) ---------------------
    def compute_G(self, level: int, w: jnp.ndarray, compute_Q: bool = False):
        """G(w) for a batch of coefficient fields. Returns (G, Q, cost)."""
        Q, cost, info, p = self.solver.solve_fwd(level, w, return_pressure=True)
        G = p @ self.g_obs[level].T  # (batch, n_obs)
        return G, Q, cost

    def likelihood(self, level: int, w: jnp.ndarray):
        """Pi(w) = exp(-|G(w) - y|^2 / (2*noise)). Returns (Pi, cost)."""
        G, _, cost = self.compute_G(level, w)
        misfit = jnp.sum((G - self.G_obs) ** 2, axis=-1)
        return jnp.exp(-misfit / (2.0 * self.noise)), cost

    def likelihood_and_Q(self, level: int, w: jnp.ndarray):
        G, Q, cost = self.compute_G(level, w, compute_Q=True)
        misfit = jnp.sum((G - self.G_obs) ** 2, axis=-1)
        return jnp.exp(-misfit / (2.0 * self.noise)), Q, cost

    def compute_R(self, level: int, w: jnp.ndarray):
        """R(w) = Q(w) * Pi(w). Returns (R, cost)."""
        like, Q, cost = self.likelihood_and_Q(level, w)
        return Q * like, cost

    # -- reference observational data ------------------------------------------
    def generate_observational_data(self, key=None) -> np.ndarray:
        """y = G(u_ref) + N(0, noise) from one prior draw at the finest
        level, or loaded from config.bayes_ref_data_file when present
        (reference: GenerateObservationalData, :125-176)."""
        cfg = self.config
        fname = cfg.bayes_ref_data_file
        if not cfg.bayes_generate_ref_data and fname and os.path.exists(fname):
            data = np.loadtxt(fname).reshape(-1)
            if data.size == self.size_obs_data:
                self.G_obs = jnp.asarray(data, dtype=self.dtype)
                return data
        if key is None:
            key = jax.random.PRNGKey(self.config.seed + 17)
        xi = self.prior.sample(0, key, 1)
        u = self.prior.eval(0, xi)
        G, _, _ = self.compute_G(0, u)
        eta = np.sqrt(self.noise) * np.asarray(
            jax.random.normal(jax.random.fold_in(key, 1), (self.size_obs_data,))
        )
        data = np.asarray(G[0], dtype=np.float64) + eta
        self.G_obs = jnp.asarray(data, dtype=self.dtype)
        if fname:
            np.savetxt(fname, data)
        return data

    def set_observational_data(self, y) -> None:
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        assert y.size == self.size_obs_data
        self.G_obs = jnp.asarray(y, dtype=self.dtype)
