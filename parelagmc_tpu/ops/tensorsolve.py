"""Tensor-product fast direct solver for the mixed RT0/P0 Schur complement.

The workhorse of the SPDE sampler and of the Darcy preconditioner. On an
axis-aligned tensor-product mesh, eliminating the velocity from the mixed
saddle system

    [[M, B^T], [B, -alpha*W]] [u; s] = [0; b]

yields the cell-space Schur complement

    S s = (B M^{-1} B^T + alpha*W) s = -b.

Because RT0 basis functions of different axes are L2-orthogonal on boxes,
M is block-diagonal per axis with 1D tridiagonal Kronecker factors, and
B = sum_a (1D difference) x (identities). Hence the symmetrized operator

    W^{-1/2} S W^{-1/2} = alpha*I + sum_a I x ... x H_a x ... x I,

where each H_a = h_a^{-1/2} d_a t_a^{-1} d_a^T h_a^{-1/2} is a *purely 1D*
symmetric PSD matrix (t_a = 1D face mass tridiagonal after boundary-condition
elimination, d_a = 1D signed difference). Diagonalizing H_a = V_a L_a V_a^T
on the host turns S^{-1} into per-axis dense matmuls plus one
diagonal scale:

    S^{-1} = W^{-1/2} (x)V_a  diag(alpha + sum L_a)^{-1}  (x)V_a^T  W^{-1/2}.

This is an *exact* solve of the same discrete system the reference solves
iteratively per sample (MINRES-BJ-GS or hybridization+AMG,
src/PDESampler.cpp:286-317,379-400 of the reference) - the batched-matmul
replacement: no per-sample Krylov iterations, deterministic cost, batched
trivially. It covers every tensor-grid configuration in the reference
(golden tests, SPE10, Egg, embedded boxes). Non-tensor meshes fall back to
the iterative path in ops/solvers.py.

With alpha = 0 and Darcy boundary conditions the same factorization gives
the exact inverse of the reference-coefficient pressure Schur complement
B M(1)^{-1} B^T, used as the (1,1)-block preconditioner for the Darcy
MINRES solve.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from parelagmc_tpu.mesh.structured import StructuredMesh


class TensorEig(NamedTuple):
    """Device-side spectral factors of the cell-space Schur complement."""

    V: Tuple[jnp.ndarray, ...]  # per axis (n_a, n_a) eigenvectors of H_a
    lam: jnp.ndarray  # (n_d, ..., n_1) modal eigenvalues alpha + sum L_a
    w_sqrt: jnp.ndarray  # (n_s,) sqrt cell volumes
    shape: Tuple[int, ...]  # cells per axis (n_1, ..., n_d), x first


def axis_schur_1d(h: np.ndarray, keep_lo: bool, keep_hi: bool) -> np.ndarray:
    """Dense 1D cell-space Schur stiffness K = d t^{-1} d^T for one axis.

    h: (n,) cell widths. keep_lo/keep_hi: whether the boundary face at the
    low/high end carries a dof (False = essential u.n = 0, eliminated).
    The full operator is S = alpha*W + sum_a [(x)_{b!=a} diag(h_b)] (x) K_a.
    """
    n = h.size
    faces = []  # kept 1D faces as indices 0..n (face i sits left of cell i)
    if keep_lo:
        faces.append(0)
    faces.extend(range(1, n))
    if keep_hi:
        faces.append(n)
    nf = len(faces)
    # 1D RT0 face mass tridiagonal: t[f,f] = sum of h/3 of adjacent cells,
    # t[f,g] = h/6 for faces sharing a cell.
    t = np.zeros((nf, nf))
    d = np.zeros((n, nf))
    pos = {f: k for k, f in enumerate(faces)}
    for i in range(n):
        lo, hi = i, i + 1
        if lo in pos:
            t[pos[lo], pos[lo]] += h[i] / 3.0
            d[i, pos[lo]] = -1.0
        if hi in pos:
            t[pos[hi], pos[hi]] += h[i] / 3.0
            d[i, pos[hi]] = +1.0
        if lo in pos and hi in pos:
            t[pos[lo], pos[hi]] += h[i] / 6.0
            t[pos[hi], pos[lo]] += h[i] / 6.0
    if nf == 0:
        return np.zeros((n, n))
    return d @ np.linalg.solve(t, d.T)


def _eig_factors(K: np.ndarray, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Spectral factors (eigvals, eigvecs) of H = h^{-1/2} K h^{-1/2}."""
    hs = 1.0 / np.sqrt(h)
    H = hs[:, None] * K * hs[None, :]
    H = 0.5 * (H + H.T)
    lam, V = np.linalg.eigh(H)
    lam = np.maximum(lam, 0.0)
    return lam, V


def _axis_factors(
    h: np.ndarray, keep_lo: bool, keep_hi: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """1D spectral factors for one axis (rediscretized fine operator)."""
    return _eig_factors(axis_schur_1d(h, keep_lo, keep_hi), h)


def build_tensor_solver(
    mesh: StructuredMesh,
    alpha: float,
    ess_attr: Optional[Sequence[int]] = None,
    dtype=jnp.float32,
) -> TensorEig:
    """Build the spectral factors of S = B M^{-1} B^T + alpha W on `mesh`.

    ess_attr follows the MFEM attribute convention (per-boundary-attribute
    0/1). None means *all* boundary velocity dofs essential (the SPDE
    sampler's setup, reference src/PDESampler.cpp:210-214).
    """
    d = mesh.dim
    if ess_attr is None:
        ess = [True] * (2 * d)

    def side_is_ess(axis: int, side: int) -> bool:
        if ess_attr is None:
            return True
        from parelagmc_tpu.mesh.structured import _mfem_bdr_attr

        return bool(ess_attr[_mfem_bdr_attr(d, axis, side) - 1] == 1)

    lams: List[np.ndarray] = []
    Vs: List[np.ndarray] = []
    for a in range(d):
        h = np.diff(mesh.axes[a])
        lam, V = _axis_factors(
            h, keep_lo=not side_is_ess(a, 0), keep_hi=not side_is_ess(a, 1)
        )
        lams.append(lam)
        Vs.append(V)
    # Modal eigenvalue grid, stored with axis order reversed (z, y, x) to
    # match reshaping of x-fastest flattened cell vectors.
    shape = mesh.shape
    lam_nd = np.asarray(alpha, dtype=np.float64)
    lam_full = np.zeros(shape[::-1], dtype=np.float64) + float(alpha)
    for a in range(d):
        bshape = [1] * d
        bshape[d - 1 - a] = shape[a]
        lam_full = lam_full + lams[a].reshape(bshape)
    return TensorEig(
        V=tuple(jnp.asarray(V, dtype=dtype) for V in Vs),
        lam=jnp.asarray(lam_full, dtype=dtype),
        w_sqrt=jnp.asarray(np.sqrt(mesh.cell_volumes()), dtype=dtype),
        shape=shape,
    )


def tensor_marginal_std(eig: TensorEig, g: float) -> np.ndarray:
    """Exact per-cell marginal standard deviation of the SPDE sampler field
    s = S^{-1} (g W^{1/2} xi), xi ~ N(0, I), computed on host from the
    spectral factors:

        Cov(s) = g^2 S^{-1} W S^{-1} = g^2 W^{-1/2} V Lam^{-2} V^T W^{-1/2}
        diag(Cov)_i = (g^2 / W_i) * sum_m prod_a V_a[i_a, m_a]^2 / lam_m^2,

    i.e. the elementwise-squared per-axis eigenvector transforms applied to
    the lam^{-2} modal grid - the same per-axis-matmul cost as one tensor
    solve of a single vector. Used by the samplers' exact marginal
    normalization (config.normalize_marginals); the reference can only
    *mitigate* its boundary variance inflation by mesh embedding
    (src/EmbeddedPDESampler.cpp:58-89), while the closed spectral form makes
    the discrete marginal exact at every cell of every level."""
    d = len(eig.shape)
    lam = np.asarray(eig.lam, dtype=np.float64)
    z = 1.0 / lam**2
    for a in range(d):
        dim = z.ndim - 1 - a
        V2 = np.asarray(eig.V[a], dtype=np.float64) ** 2
        z = np.moveaxis(np.moveaxis(z, dim, -1) @ V2.T, -1, dim)
    w = np.asarray(eig.w_sqrt, dtype=np.float64) ** 2
    return g * np.sqrt(np.maximum(z.reshape(-1), 0.0) / w)


def _transform(x: jnp.ndarray, mats: Sequence[jnp.ndarray], shape, transpose: bool,
               precision=lax.Precision.HIGHEST):
    """Apply the per-axis orthogonal transforms to (..., n_s) cell vectors.

    `x` is flattened x-fastest; reshaped to (..., n_d, ..., n_1) so axis 0
    (x) is the last array dimension. `precision` defaults to HIGHEST: a
    float32 product at DEFAULT precision may run in TF32 on the GPU, which
    keeps ~3 decimal digits of the field (chip_smoke.py's sampler phase
    measures both against a float64 host oracle).
    """
    d = len(shape)
    batch = x.shape[:-1]
    z = x.reshape(batch + tuple(shape[::-1]))
    for a in range(d):
        # Array dim of mesh axis a.
        dim = z.ndim - 1 - a
        M = mats[a] if not transpose else mats[a].T
        # contract: z[..., i, ...] M[i, m] -> move axis to last, matmul, move back.
        z = jnp.moveaxis(z, dim, -1)
        z = jnp.matmul(z, M, precision=precision)
        z = jnp.moveaxis(z, -1, dim)
    return z.reshape(batch + (int(np.prod(shape)),))


def tensor_solve(eig: TensorEig, b: jnp.ndarray,
                 precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """s = S^{-1} b for (..., n_s) right-hand sides."""
    z = b / eig.w_sqrt
    # V^T along each axis, modal scale, V along each axis.
    z = _transform(z, eig.V, eig.shape, transpose=False, precision=precision)
    lam = eig.lam.reshape(-1)
    z = z / lam
    z = _transform(z, eig.V, eig.shape, transpose=True, precision=precision)
    return z / eig.w_sqrt


def tensor_sample(eig: TensorEig, xi: jnp.ndarray, scale: float) -> jnp.ndarray:
    """Draw s = scale * W^{-1/2} V diag(1/lam) V^T xi - the SPDE sampler's
    field given white noise xi (the closed form of S^{-1} (scale*W^{1/2} xi),
    see samplers/pde.py)."""
    z = _transform(xi, eig.V, eig.shape, transpose=False)
    z = z / eig.lam.reshape(-1)
    z = _transform(z, eig.V, eig.shape, transpose=True)
    return scale * z / eig.w_sqrt
