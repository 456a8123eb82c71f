"""Covariance operators for truncated Karhunen-Loeve expansions.

Host-side analogs of the reference's CovarianceFunction hierarchy
(/root/reference/src/CovarianceFunction.hpp, AnalyticExponentialCovariance.cpp,
MaternCovariance.cpp): compute (theta_k, b_k) eigenpairs of a covariance
operator discretized on the P0 cell space; the KL sampler then draws
s = sum_k sqrt(theta_k) b_k xi_k on device.

* AnalyticExponentialCovariance - separable exponential kernel
  cov(x,y) = sigma^2 exp(-sum_a |x_a - y_a| / lambda_a). Per axis, the 1D
  eigenfrequencies omega_n solve the transcendental equation
  tan(omega) = 2 L omega / (L^2 omega^2 - 1) (L = lambda/length), found by
  bisection between the poles (reference:
  AnalyticExponentialCovariance.cpp:222-281); eigenvalues
  theta = 2 l L / (L^2 omega^2 + 1) and eigenfunctions
  b(x) = (sin(omega x / l) + L omega cos(omega x / l)) / l evaluated at cell
  centers, discretely normalized to unit W-norm; d-dimensional modes are
  tensor products renormalized the same way (reference :126-216).

* MaternCovariance - dense Matern kernel at cell centers with
  nu = 2 - d/2 and kappa = 1/correlation_length (exp kernel in 3D,
  r*K1(r) in 2D; reference MaternCovariance.cpp:432-449). The eigenpairs
  solve the *Galerkin/Nystrom* generalized problem

      (W C W) b = theta W b   <=>   C W b = theta b,

  symmetrized as eigh(W^{1/2} C W^{1/2}), with b scaled to unit W-norm.
  This is the mathematically consistent discretization of the integral
  covariance operator: sum_k theta_k b_k(x)^2 -> C(x,x) = 1, so the
  truncated field's marginal variance approaches sigma^2 like the analytic
  variant's (the reference validates both side by side in SamplerTest).

Eigenvalues are returned sorted descending so truncation keeps the most
energetic modes.
"""

from __future__ import annotations

import abc
import math
from typing import List, Tuple

import numpy as np

from parelagmc_tpu.mesh.structured import StructuredMesh
from parelagmc_tpu.utils.special import bessk1


class CovarianceFunction(abc.ABC):
    """Contract: solve_eigenvalue() fills eigenvalues (descending) and
    eigenvectors (columns, unit W-norm at fine-level cell centers)."""

    eigenvalues: np.ndarray  # (nmodes,)
    eigenvectors: np.ndarray  # (n_cells, nmodes)

    @abc.abstractmethod
    def solve_eigenvalue(self) -> None: ...

    @property
    def num_modes(self) -> int:
        return int(self.eigenvalues.shape[0])

    def variability_fraction(self, mesh: StructuredMesh) -> float:
        """Fraction of total field variability captured by the truncation
        (reference prints this in ShowMe: sum(theta) / |D|)."""
        return float(self.eigenvalues.sum() / mesh.cell_volumes().sum())


def _solve_omegas(nmodes: int, scaled_corlen: float) -> np.ndarray:
    """Positive roots of tan(w) = 2*L*w / (L^2 w^2 - 1), bracketed between
    consecutive poles of the equation (pi/2 + n*pi and the point 1/L)."""
    L = scaled_corlen
    asyx = 1.0 / L
    # Pole/bracket points.
    brackets: List[float] = []
    if asyx < math.pi / 2.0:
        brackets.append(asyx)
    brackets.append(math.pi / 2.0)
    while len(brackets) < nmodes + 1:
        nxt = brackets[-1] + math.pi
        if brackets[-1] < asyx < nxt:
            brackets.append(asyx)
            if len(brackets) < nmodes + 1:
                brackets.append(brackets[-2] + math.pi)
        else:
            brackets.append(nxt)

    def f(w: float) -> float:
        return math.tan(w) - (2.0 * L * w) / (L * L * w * w - 1.0)

    roots = []
    for j in range(nmodes):
        xl, xr = 1.001 * brackets[j], 0.999 * brackets[j + 1]
        fl = f(xl)
        for _ in range(200):
            xm = 0.5 * (xl + xr)
            fm = f(xm)
            if abs(fm) < 1e-12 or (xr - xl) < 1e-14:
                break
            if fl * fm < 0:
                xr = xm
            else:
                xl, fl = xm, fm
        roots.append(0.5 * (xl + xr))
    return np.asarray(roots)


def _domain_axes(mesh):
    """(origins, lengths) per axis: grid lines for StructuredMesh, the
    bounding box for unstructured box-domain meshes (the separable
    exponential covariance is defined on a box either way)."""
    if hasattr(mesh, "axes"):
        return (
            [float(a[0]) for a in mesh.axes],
            [float(a[-1] - a[0]) for a in mesh.axes],
        )
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    return list(map(float, lo)), list(map(float, hi - lo))


class AnalyticExponentialCovariance(CovarianceFunction):
    def __init__(
        self,
        mesh: StructuredMesh,
        correlation_length,
        nmodes_per_dim,
    ):
        self.mesh = mesh
        d = mesh.dim
        if np.isscalar(correlation_length):
            correlation_length = [float(correlation_length)] * d
        self.corlens = [float(c) for c in correlation_length]
        if np.isscalar(nmodes_per_dim):
            nmodes_per_dim = [int(nmodes_per_dim)] * d
        self.nmodes_per_dim = [int(n) for n in nmodes_per_dim]
        total = int(np.prod(self.nmodes_per_dim))
        if total > mesh.num_cells:
            raise ValueError("more KLE modes than cells")
        self.eigenvalues = np.zeros(0)
        self.eigenvectors = np.zeros((mesh.num_cells, 0))

    def solve_eigenvalue(self) -> None:
        mesh = self.mesh
        d = mesh.dim
        W = mesh.cell_volumes()
        centers = mesh.cell_centers()
        origins, lengths = _domain_axes(mesh)
        evals_1d: List[np.ndarray] = []
        evecs_1d: List[np.ndarray] = []  # (n_cells, nmodes_a) values
        for a in range(d):
            length = lengths[a]
            L = self.corlens[a] / length
            omegas = _solve_omegas(self.nmodes_per_dim[a], L)
            theta = 2.0 * length * L / (L * L * omegas ** 2 + 1.0)
            x = (centers[:, a] - origins[a])[:, None] * omegas[None, :] / length
            b = (np.sin(x) + L * omegas[None, :] * np.cos(x)) / length
            # Discrete unit W-norm per mode.
            b /= np.sqrt((W[:, None] * b * b).sum(axis=0))[None, :]
            evals_1d.append(theta)
            evecs_1d.append(b)
        # Tensor products over all mode combinations.
        grids = np.meshgrid(
            *[np.arange(n) for n in self.nmodes_per_dim], indexing="ij"
        )
        idx = [g.ravel() for g in grids]
        theta = np.ones(idx[0].size)
        b = np.ones((mesh.num_cells, idx[0].size))
        for a in range(d):
            theta = theta * evals_1d[a][idx[a]]
            b = b * evecs_1d[a][:, idx[a]]
        b /= np.sqrt((W[:, None] * b * b).sum(axis=0))[None, :]
        order = np.argsort(theta)[::-1]
        self.eigenvalues = theta[order]
        self.eigenvectors = b[:, order]

    def check_orthogonality(self) -> float:
        """Max |b_i^T W b_j - delta_ij| (reference:
        AnalyticExponentialCovariance::CheckOrthogonalityEigenvectors)."""
        W = self.mesh.cell_volumes()
        G = self.eigenvectors.T @ (W[:, None] * self.eigenvectors)
        return float(np.abs(G - np.eye(G.shape[0])).max())


class MaternCovariance(CovarianceFunction):
    def __init__(self, mesh: StructuredMesh, correlation_length: float, nmodes: int):
        self.mesh = mesh
        self.corlen = float(correlation_length)
        self.kappa = 1.0 / self.corlen
        d = mesh.dim
        self.nu = 2.0 - d / 2.0
        self.nmodes = min(int(nmodes), mesh.num_cells)
        self.eigenvalues = np.zeros(0)
        self.eigenvectors = np.zeros((mesh.num_cells, 0))

    def kernel(self, r: np.ndarray) -> np.ndarray:
        """Matern correlation at scaled distance r = kappa * |x - y|
        (reference MaternCovariance::Compute, :432-449)."""
        r = np.asarray(r)
        out = np.ones_like(r)
        pos = r >= 1e-10
        if self.nu == 0.5:
            out = np.where(pos, np.exp(-r), 1.0)
        else:  # nu == 1 (2D)
            z = np.sqrt(2.0 * self.nu) * r
            scale = 1.0 / (math.gamma(self.nu) * 2.0 ** (self.nu - 1.0))
            zsafe = np.where(pos, z, 1.0)
            out = np.where(pos, scale * zsafe * bessk1(zsafe), 1.0)
        return out

    def covariance_matrix(self) -> np.ndarray:
        centers = self.mesh.cell_centers()
        diff = centers[:, None, :] - centers[None, :, :]
        r = self.kappa * np.sqrt((diff ** 2).sum(axis=-1))
        return self.kernel(r)

    # -- scalable matrix-free kernel products --------------------------------
    def _uniform_grid_shape(self):
        """(shape, spacings) when the mesh is a uniform tensor grid (per
        axis), else None - enables the FFT block-Toeplitz fast path."""
        if not isinstance(self.mesh, StructuredMesh):
            return None
        hs = []
        for a in self.mesh.axes:
            d = np.diff(a)
            if not np.allclose(d, d[0], rtol=1e-10, atol=1e-14):
                return None
            hs.append(float(d[0]))
        return self.mesh.shape, hs

    def _fft_symbol(self, shape, hs):
        """FFT of the kernel on the circulant embedding torus (2n per axis):
        the stationary kernel makes C block-Toeplitz on a uniform grid, so
        C @ X is exact via padded FFT convolution - O(n log n) instead of
        the reference's dense/LOBPCG O(n^2) products
        (MaternCovariance.cpp:357-420)."""
        d = len(shape)
        wraps = []
        for n_a, h in zip(shape, hs):
            m = 2 * n_a
            idx = np.arange(m)
            off = np.minimum(idx, m - idx).astype(np.float64) * h
            wraps.append(off)
        grids = np.meshgrid(*wraps, indexing="ij")
        r = self.kappa * np.sqrt(sum(g ** 2 for g in grids))
        ker = self.kernel(r)
        return np.fft.rfftn(ker)

    def _matmat(self, X: np.ndarray, block: int = 2048) -> np.ndarray:
        """C @ X without materializing C. FFT path on uniform grids;
        blocked kernel rows otherwise (O(n * block) memory)."""
        uni = self._uniform_grid_shape()
        n, k = X.shape
        if uni is not None:
            shape, hs = uni
            sym = self._fft_symbol(shape, hs)
            out = np.empty_like(X)
            # x-fastest flattening => reshape to (z, y, x) = reversed shape,
            # transpose to (x, y, z) ordering of `shape`.
            rev = tuple(reversed(shape))
            axes_perm = tuple(reversed(range(len(shape))))
            for j in range(k):
                g = X[:, j].reshape(rev).transpose(axes_perm)
                pad = np.zeros([2 * s for s in shape])
                pad[tuple(slice(0, s) for s in shape)] = g
                axes = tuple(range(len(shape)))
                conv = np.fft.irfftn(
                    np.fft.rfftn(pad, axes=axes) * sym,
                    s=[2 * s for s in shape], axes=axes,
                )
                res = conv[tuple(slice(0, s) for s in shape)]
                out[:, j] = res.transpose(axes_perm).reshape(-1)
            return out
        centers = self.mesh.cell_centers()
        out = np.zeros((n, k))
        for s in range(0, n, block):
            e = min(s + block, n)
            diff = centers[s:e, None, :] - centers[None, :, :]
            rows = self.kernel(self.kappa * np.sqrt((diff ** 2).sum(axis=-1)))
            out[s:e] = rows @ X
        return out

    def solve_eigenvalue(
        self,
        dense_cutoff: int = 4096,
        oversample: int = 20,
        power_iters: int = 4,
        seed: int = 7,
    ) -> None:
        """Leading (theta, b) eigenpairs of the Galerkin/Nystrom problem.

        Small meshes: dense eigh (exact). Large meshes: randomized subspace
        iteration on A = W^{1/2} C W^{1/2} with matrix-free kernel products
        (_matmat) - the matrix-free replacement of the reference's hypre
        LOBPCG+BoomerAMG large-problem path (MaternCovariance.cpp:357-420).
        Oracle-tested against the dense path (tests/test_kl.py)."""
        import scipy.linalg as sla

        W = self.mesh.cell_volumes()
        ws = np.sqrt(W)
        n = int(self.mesh.num_cells)
        if n <= dense_cutoff:
            C = self.covariance_matrix()
            A = ws[:, None] * C * ws[None, :]
            theta, Y = sla.eigh(A, subset_by_index=(n - self.nmodes, n - 1))
            theta = theta[::-1]
            Y = Y[:, ::-1]
        else:
            k = min(self.nmodes + oversample, n)
            rng = np.random.default_rng(seed)
            Q = rng.standard_normal((n, k))
            for _ in range(power_iters + 1):
                Z = ws[:, None] * self._matmat(ws[:, None] * Q)
                Q, _ = np.linalg.qr(Z)
            T = Q.T @ (ws[:, None] * self._matmat(ws[:, None] * Q))
            T = 0.5 * (T + T.T)
            theta_all, S = sla.eigh(T)
            order = np.argsort(theta_all)[::-1][: self.nmodes]
            theta = theta_all[order]
            Y = Q @ S[:, order]
        b = Y / ws[:, None]  # unit W-norm automatically (Y orthonormal)
        self.eigenvalues = np.maximum(theta, 0.0)
        self.eigenvectors = b
