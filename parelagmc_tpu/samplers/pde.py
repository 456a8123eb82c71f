"""SPDE-based Matern random field samplers (plain, embedded, projection).

The reference's flagship capability (src/PDESampler.cpp,
src/EmbeddedPDESampler.cpp, src/L2ProjectionPDESampler.cpp): draw a Gaussian
(or log-normal) field s with Matern covariance on a mesh by solving one
realization of the mixed-FEM stochastic reaction-diffusion equation

    kappa^2 s - div(grad s) = g * (white noise),   u.n = 0 on the boundary,

with kappa = 1/correlation_length, nu = 2 - d/2 fixed by the order of the
SPDE, and g the scaling that normalizes the marginal variance
(utils/special.matern_spde_scaling, reference src/Utilities.hpp:187-200).

Discrete realization pipeline (one batch of samples, all under jit):

    xi  ~ N(0, sigma^2 I)                                (sample_size(level),)
    rhs = g * sqrt(diag(W_xi)) * xi                      white noise load
    rhs -> restricted through P_l2^T to the target level (MLMC coupling,
           reference src/PDESampler.cpp:361-368)
    s   = S_level^{-1} rhs,  S = B M^{-1} B^T + alpha W  (exact tensor solve)
    s  -> exp(s) if log-normal.

On tensor-product meshes S^{-1} is applied exactly by the spectral
Kronecker solver (ops/tensorsolve.py) - per-axis dense matmuls, no Krylov
iterations (the reference runs MINRES-BJ-GS or hybridization+AMG per sample,
src/PDESampler.cpp:379-400).

Variants:
* SPDESampler             - solve on the original mesh. Reflecting boundary
  conditions inflate the variance near the boundary (the known artifact the
  embedded variants exist to fix).
* EmbeddedSPDESampler     - solve on a *matching* enlarged mesh, restrict to
  the original cells by 0/1 selection (reference src/EmbeddedPDESampler.cpp:58-89).
* L2ProjectionSPDESampler - solve on a *non-matching* enlarged mesh, project
  to the original mesh with the mortar coupling operator G. On axis-aligned
  tensor grids G factorizes per axis into 1D overlap matrices, so the
  mortar assembly (reference: distributed tree search + polyhedron clipping,
  src/transfer/ParMortarAssembler.cpp) reduces to exact interval
  intersections at setup time; runtime is one static ELL apply.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import scipy.sparse as sp

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import GeometricHierarchy
from parelagmc_tpu.mesh.structured import StructuredMesh
from parelagmc_tpu.ops.ell import ELL, ell_apply, pack_csr_to_ell
from parelagmc_tpu.ops.tensorsolve import TensorEig, build_tensor_solver, tensor_solve
from parelagmc_tpu.samplers.base import MLSampler
from parelagmc_tpu.utils.special import matern_spde_scaling


def restrict_cells(x: jnp.ndarray, fine_shape: Tuple[int, ...]) -> jnp.ndarray:
    """P_l2^T: sum a fine cell field (..., prod(fine_shape)) into parent
    cells of the once-coarsened mesh. Pure reshape+sum on tensor grids."""
    d = len(fine_shape)
    batch = x.shape[:-1]
    rs: List[int] = []
    for a in range(d - 1, -1, -1):  # array dims are (z, y, x)
        rs.extend([fine_shape[a] // 2, 2])
    z = x.reshape(batch + tuple(rs))
    axes = tuple(len(batch) + 2 * i + 1 for i in range(d))
    z = z.sum(axis=axes)
    return z.reshape(batch + (int(np.prod(fine_shape)) // (2 ** d),))


def prolong_cells(x: jnp.ndarray, coarse_shape: Tuple[int, ...]) -> jnp.ndarray:
    """P_l2: inject a coarse cell field into the children of the refined
    mesh (piecewise-constant prolongation)."""
    d = len(coarse_shape)
    batch = x.shape[:-1]
    z = x.reshape(batch + tuple(coarse_shape[::-1]))
    for i in range(d):
        z = jnp.repeat(z, 2, axis=len(batch) + i)
    return z.reshape(batch + (int(np.prod(coarse_shape)) * (2 ** d),))


def axis_restriction_matrices(fine_mesh, coarse_mesh, dtype):
    """Per-axis 0/1 aggregation matrices R_a (nc_a, nf_a) whose tensor
    product is P_l2^T for any nested structured coarsening (dyadic or not)."""
    from parelagmc_tpu.fem.hierarchy import axis_parent_map

    mats = []
    for a in range(fine_mesh.dim):
        par = axis_parent_map(fine_mesh.axes[a], coarse_mesh.axes[a])
        nf = par.size
        nc = coarse_mesh.axes[a].size - 1
        R = np.zeros((nc, nf))
        R[par, np.arange(nf)] = 1.0
        mats.append(jnp.asarray(R, dtype=dtype))
    return tuple(mats)


def restrict_cells_matmul(
    x: jnp.ndarray, mats, fine_shape: Tuple[int, ...]
) -> jnp.ndarray:
    """P_l2^T via per-axis dense 0/1 matmuls; general branching. HIGHEST
    precision keeps float32 sums exact where DEFAULT may use TF32."""
    d = len(fine_shape)
    batch = x.shape[:-1]
    z = x.reshape(batch + tuple(fine_shape[::-1]))
    for a in range(d):
        dim = z.ndim - 1 - a
        z = jnp.moveaxis(z, dim, -1)
        z = jnp.matmul(z, mats[a].T, precision=lax.Precision.HIGHEST)
        z = jnp.moveaxis(z, -1, dim)
    return z.reshape(batch + (-1,))


class _TensorSPDEBase(MLSampler):
    """Shared machinery: per-level tensor solvers on a 'solve' hierarchy."""

    def __init__(self, solve_hierarchy: GeometricHierarchy, config: ProblemConfig, dtype):
        self.hierarchy = solve_hierarchy
        self.config = config
        self.dtype = dtype
        d = solve_hierarchy.levels[0].dim
        self.ndim = d
        self.corlen = float(config.correlation_length)
        self.alpha = 1.0 / self.corlen ** 2
        self.g = matern_spde_scaling(self.corlen, d)
        self.sigma = math.sqrt(float(config.variance))
        self.lognormal = bool(config.lognormal)
        # Per-level rediscretized operators. On nested tensor RT0/P0 spaces
        # the RT embedding is exact, so the reference's AMGe Galerkin
        # coarsening of the (unit-coefficient) mixed SPDE blocks
        # (src/PDESampler.cpp:160-168 via ParELAG DeRhamSequence) produces
        # exactly these rediscretized coarse operators - there is no
        # separate "galerkin" sampler variant to build.
        self.eigs: List[TensorEig] = [
            build_tensor_solver(lvl.mesh, self.alpha, ess_attr=None, dtype=dtype)
            for lvl in solve_hierarchy.levels
        ]
        # Optional exact marginal normalization (config.normalize_marginals):
        # scale the Gaussian field per cell by sigma / model_std(cell), with
        # model_std computed EXACTLY from the spectral factors
        # (ops/tensorsolve.tensor_marginal_std). This removes both known
        # artifacts of the SPDE sampler - boundary variance inflation (which
        # the reference's embedded variants only mitigate) and the
        # per-level marginal-variance mismatch that destroys MLMC variance
        # decay when a level under-resolves the correlation length
        # (measured on SPE10: examples/spe10_rate_diagnostics.py found
        # beta = -0.5 from exactly this). Off by default for
        # statistical parity with the reference's plain sampler.
        self.field_scale: Optional[List[jnp.ndarray]] = None
        if getattr(config, "normalize_marginals", False):
            from parelagmc_tpu.ops.tensorsolve import tensor_marginal_std

            self.field_scale = [
                jnp.asarray(
                    1.0 / tensor_marginal_std(eig, self.g), dtype=dtype
                )
                for eig in self.eigs
            ]
        self.w_sqrt = [
            jnp.asarray(lvl.w_sqrt, dtype=dtype) for lvl in solve_hierarchy.levels
        ]
        self.shapes = [lvl.mesh.shape for lvl in solve_hierarchy.levels]
        self.restrict_mats = [
            axis_restriction_matrices(
                solve_hierarchy.levels[l].mesh,
                solve_hierarchy.levels[l + 1].mesh,
                dtype,
            )
            for l in range(solve_hierarchy.nlevels - 1)
        ]

    # -- noise ---------------------------------------------------------------
    def sample_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key, nsamples: int) -> jnp.ndarray:
        from parelagmc_tpu.ops.prng import sample_normals

        return self.sigma * sample_normals(
            key, (nsamples, self.sample_size(level)), dtype=self.dtype
        )

    # -- Gaussian solve on the solve mesh -------------------------------------
    def _solve_gaussian(
        self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None
    ) -> jnp.ndarray:
        if xi_level is None:
            xi_level = level
        assert xi_level <= level, "noise must live on the same or a finer level"
        rhs = self.g * self.w_sqrt[xi_level] * xi
        for l in range(xi_level, level):
            rhs = restrict_cells_matmul(rhs, self.restrict_mats[l], self.shapes[l])
        s = tensor_solve(self.eigs[level], rhs)
        if self.field_scale is not None:
            s = s * self.field_scale[level]
        return s

    def nnz(self, level: int) -> int:
        # Modal operator size: eigen-factor entries (observability metric).
        return sum(int(v.shape[0]) ** 2 for v in self.eigs[level].V) + int(
            np.prod(self.shapes[level])
        )


class SPDESampler(_TensorSPDEBase):
    """SPDE sampler on the original mesh (reference: src/PDESampler.cpp)."""

    def __init__(self, hierarchy: GeometricHierarchy, config: ProblemConfig, dtype=jnp.float32):
        super().__init__(hierarchy, config, dtype)
        self._mass_solvers = {}

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        return jnp.exp(s) if self.lognormal else s

    def eval_with_flux(
        self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None
    ):
        """(s, u): the field plus the auxiliary H(div) flux of the mixed SPDE
        system, u = -M^{-1} B^T s_gauss (the reference's Eval overload
        returning the velocity block, src/PDESampler.cpp:537-613). Both get
        exp() under the log-normal flag, matching the reference."""
        from parelagmc_tpu.ops.mass_solve import build_mass_tridiag_solver

        s_g = self._solve_gaussian(level, xi, xi_level)
        if level not in self._mass_solvers:
            lvl = self.hierarchy.levels[level]
            ess = lvl.ess_faces(np.ones(2 * self.ndim, dtype=int))
            self._mass_solvers[level] = (
                build_mass_tridiag_solver(lvl, ess, dtype=self.dtype),
                jnp.asarray(ess),
            )
        solver, ess = self._mass_solvers[level]
        lvl = self.hierarchy.levels[level]
        face_cells = jnp.asarray(lvl.face_cells, dtype=jnp.int32)
        face_signs = jnp.asarray(lvl.face_signs, dtype=self.dtype)
        bts = jnp.sum(
            jnp.take(s_g, face_cells.reshape(-1), axis=-1).reshape(
                s_g.shape[:-1] + face_cells.shape
            )
            * face_signs,
            axis=-1,
        )
        bts = jnp.where(ess, 0.0, bts)  # u.n = 0 on the boundary
        ones = jnp.ones(s_g.shape[:-1] + (lvl.n_s,), dtype=self.dtype)
        u = -solver(ones, bts)
        s = jnp.exp(s_g) if self.lognormal else s_g
        u = jnp.exp(u) if self.lognormal else u  # reference exp()s u too (:605-611)
        return s, u


class EmbeddedSPDESampler(_TensorSPDEBase):
    """SPDE sampler on a matching enlarged mesh with 0/1 selection back to
    the original mesh (reference: src/EmbeddedPDESampler.cpp). Avoids the
    boundary variance inflation of the plain sampler."""

    def __init__(
        self,
        hierarchy: GeometricHierarchy,  # original-mesh hierarchy
        embed_hierarchy: GeometricHierarchy,
        config: ProblemConfig,
        dtype=jnp.float32,
    ):
        super().__init__(embed_hierarchy, config, dtype)
        from parelagmc_tpu.mesh.factories import embedded_selection

        self.orig_hierarchy = hierarchy
        # Per-level selection: embedded cell indices matching original cells
        # (matching embedding holds on every level of the geometric
        # hierarchy because both base meshes refine in lockstep).
        self.selection = [
            jnp.asarray(
                embedded_selection(embed_hierarchy.levels[l].mesh, hierarchy.levels[l].mesh),
                dtype=jnp.int32,
            )
            for l in range(hierarchy.nlevels)
        ]

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        s = jnp.take(s, self.selection[level], axis=-1)
        return jnp.exp(s) if self.lognormal else s

    def embed_eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        """Realization on the full embedded mesh (reference: EmbedEval,
        src/EmbeddedPDESampler.hpp:106-117)."""
        s = self._solve_gaussian(level, xi, xi_level)
        return jnp.exp(s) if self.lognormal else s


def overlap_matrix_1d(orig_axis: np.ndarray, embed_axis: np.ndarray) -> sp.csr_matrix:
    """1D interval-overlap matrix O[i, j] = |cell_i(orig) intersect cell_j(embed)|."""
    no, ne = orig_axis.size - 1, embed_axis.size - 1
    rows, cols, vals = [], [], []
    for i in range(no):
        a0, a1 = orig_axis[i], orig_axis[i + 1]
        j0 = np.searchsorted(embed_axis, a0, side="right") - 1
        j0 = max(j0, 0)
        for j in range(j0, ne):
            b0, b1 = embed_axis[j], embed_axis[j + 1]
            if b0 >= a1 - 1e-14:
                break
            ov = min(a1, b1) - max(a0, b0)
            if ov > 1e-14:
                rows.append(i)
                cols.append(j)
                vals.append(ov)
    return sp.csr_matrix((vals, (rows, cols)), shape=(no, ne))


def mortar_coupling(orig: StructuredMesh, embed: StructuredMesh) -> sp.csr_matrix:
    """Tensor-grid mortar coupling G[i, j] = |K_i^orig intersect K_j^embed|
    (the L2 mortar mass between the two P0 spaces). Kronecker product of 1D
    overlaps, axes ordered so x varies fastest - the exact, setup-time
    equivalent of the reference's distributed mortar assembly
    (src/transfer/ParMortarAssembler.cpp:903-1118) for axis-aligned grids."""
    G = None
    for a in range(orig.dim - 1, -1, -1):
        Oa = overlap_matrix_1d(orig.axes[a], embed.axes[a])
        G = Oa if G is None else sp.kron(G, Oa, format="csr")
    return G.tocsr()


class L2ProjectionSPDESampler(_TensorSPDEBase):
    """SPDE sampler on a non-matching enlarged mesh with mortar L2 projection
    back to the original mesh (reference: src/L2ProjectionPDESampler.cpp):
    s_orig = W_orig^{-1} G s_embed, G coarsened per level (equal to
    rediscretizing the overlap on the level meshes, which is what the
    Galerkin triple product Gt[l+1] = RAP(P_orig, Gt[l], P_embed) computes
    for P0 injections - reference src/L2ProjectionPDESampler.cpp:507-514)."""

    def __init__(
        self,
        hierarchy: GeometricHierarchy,
        embed_hierarchy: GeometricHierarchy,
        config: ProblemConfig,
        dtype=jnp.float32,
    ):
        super().__init__(embed_hierarchy, config, dtype)
        self.orig_hierarchy = hierarchy
        self.G: List[ELL] = []
        self.Gt: List[ELL] = []
        self.winv_orig = []
        self.winv_embed = []
        for l in range(hierarchy.nlevels):
            om = hierarchy.levels[l].mesh
            em = embed_hierarchy.levels[l].mesh
            G = mortar_coupling(om, em)
            if G[0].sum() <= 0:
                raise ValueError("No intersection, no transfer!")
            self.G.append(pack_csr_to_ell(G, dtype))
            self.Gt.append(pack_csr_to_ell(G.T.tocsr(), dtype))
            self.winv_orig.append(
                jnp.asarray(1.0 / hierarchy.levels[l].W, dtype=dtype)
            )
            self.winv_embed.append(
                jnp.asarray(1.0 / embed_hierarchy.levels[l].W, dtype=dtype)
            )

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def project(self, level: int, s_embed: jnp.ndarray) -> jnp.ndarray:
        return self.winv_orig[level] * ell_apply(self.G[level], s_embed)

    def transfer(self, level: int, x_embed: jnp.ndarray) -> jnp.ndarray:
        """L2-project an embedded cell field to the original mesh (reference:
        L2ProjectionPDESampler::Transfer, used to hand the same noise to a
        plain sampler in SamplerTest)."""
        return self.project(level, x_embed)

    def transfer_to_embed(self, level: int, x_orig: jnp.ndarray) -> jnp.ndarray:
        """L2-project an original-mesh cell field to the embedded mesh."""
        return self.winv_embed[level] * ell_apply(self.Gt[level], x_orig)

    def eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        s = self.project(level, s)
        return jnp.exp(s) if self.lognormal else s

    def embed_eval(self, level: int, xi: jnp.ndarray, xi_level: Optional[int] = None):
        s = self._solve_gaussian(level, xi, xi_level)
        return jnp.exp(s) if self.lognormal else s
