"""parelagmc_tpu — a JAX multilevel Monte Carlo framework for PDEs with
random coefficients.

A from-scratch JAX/XLA re-design of the capabilities of LLNL/ParELAGMC
(reference: /root/reference, C++/MPI):

* Gaussian / log-normal Matern random fields on meshes via
  - an SPDE sampler (mixed FEM stochastic reaction-diffusion solve),
  - truncated Karhunen-Loeve expansions (analytic exponential or Matern
    covariance),
  with plain, matching-mesh-embedded and non-matching-mesh-embedded variants.
* A mixed Darcy forward model with per-sample permeability.
* Single-level MC and multilevel MC estimator managers with adaptive sample
  allocation, plus Bayesian ratio / splitting estimators.

Design stance (batched accelerator code, not a port):
* All mesh-dependent, sample-independent operators (mass matrices,
  divergence incidence, prolongators, mortar transfer) are precomputed on the
  host at setup and shipped to the device as static gather/ELL operands.
* Samples are the parallel axis: the whole realization pipeline
  (noise -> SPDE solve -> Darcy solve -> QoI) is jitted and vmapped over a
  batch of realizations, and the batch is sharded over a device mesh.
  (The reference draws samples sequentially and parallelizes spatially over
  MPI ranks; see SURVEY.md section 2.3.)
* Iterative solves use fixed-shape batched Krylov (CG/MINRES) with
  multigrid / Chebyshev preconditioners built from the precomputed geometric
  hierarchy; convergence is handled by masking, not dynamic shapes.
"""

__version__ = "0.1.0"

from parelagmc_tpu.config import ProblemConfig  # noqa: F401
