"""Geometric multigrid V-cycle preconditioner.

The batched replacement for hypre BoomerAMG/ADS/AMS (reference solver
configs, e.g. src/PDESampler_Legacy.cpp:210-235): the MLMC hierarchy already
provides nested levels with exact finite-element transfer operators, so the
preconditioner is a Galerkin-quality geometric V-cycle built entirely from
precomputed static ELL operators:

* per-level operator A_l (rediscretized on level l's mesh; exact Galerkin
  for unit coefficients by nestedness - tests/test_fem.py),
* damped-Jacobi smoothing (symmetric: same sweeps pre and post, so the
  V-cycle is an SPD operator and a valid CG preconditioner),
* dense coarsest-level inverse applied as a batched matmul.

The recursion over levels is a Python loop over a static tuple, unrolled at
trace time - no dynamic control flow.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax
import numpy as np

from parelagmc_tpu.ops.ell import ELL, ell_apply, pack_csr_to_ell


class LineSmoother(NamedTuple):
    """Tridiagonal block-Jacobi ("line relaxation") smoother data along one
    grid axis. On strongly anisotropic operators (e.g. SPE10's z-spacing
    2 ft vs 20/10 ft in x/y) point Jacobi leaves the strongly-coupled
    error components unsmoothed and the V-cycle stalls; solving whole
    lines along the strong axis is the classical fix (the structured-grid
    analog of BoomerAMG's strength-based coarsening). Solved with the
    batched Thomas scan from ops/mass_solve."""

    dl: jnp.ndarray  # (nlines, m) sub-diagonal, first column 0
    d: jnp.ndarray  # (nlines, m) line diagonal
    du: jnp.ndarray  # (nlines, m) super-diagonal, last column 0
    perm: jnp.ndarray  # (n,) int32: line-major gather order
    iperm: jnp.ndarray  # (n,) int32: inverse permutation
    omega: float  # damping for the block-Jacobi update


class MGLevel(NamedTuple):
    A: ELL
    inv_diag: jnp.ndarray  # (n,)
    P: ELL  # prolongation (rows: fine dofs of the NEXT level up? see below)
    Pt: ELL  # restriction
    line: object = None  # Optional[Tuple[LineSmoother, ...]] (ADI order)


class MGHierarchy(NamedTuple):
    # levels[l] holds operator of level l plus transfer to level l+1
    levels: Tuple[MGLevel, ...]
    coarse_A: ELL
    coarse_inv: jnp.ndarray  # (nc, nc) dense inverse ((0,0) if unused)
    omega: float
    coarse_inv_diag: jnp.ndarray  # (nc,) Jacobi fallback for the coarsest
    coarse_sweeps: int  # 0 => dense solve; else Jacobi sweeps at coarsest


def _spectral_omega(A, dinv: np.ndarray, iters: int = 30) -> float:
    """1 / lambda_max(D^{-1} A) by host power iteration: guarantees the
    damped-Jacobi smoother is a contraction (eigenvalues of omega D^{-1}A
    in (0, 1]), hence an SPD V-cycle - essential for operators whose
    diagonally-scaled spectrum exceeds 2 (e.g. divergence-dominated
    reduced H(div) systems, where a fixed 0.7 makes the cycle indefinite
    and CG breaks down)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        lam = float(np.linalg.norm(y))
        if lam <= 0:
            return 1.0
        x = y / lam
    return 1.0 / (1.05 * lam)  # small safety margin


def _host_thomas(dl, d, du, b):
    """Vectorized host Thomas solve over (nlines, m) systems (no pivoting;
    SPD diagonally-dominant lines)."""
    m = d.shape[1]
    c = np.zeros_like(d)
    g = np.zeros_like(b)
    c[:, 0] = du[:, 0] / d[:, 0]
    g[:, 0] = b[:, 0] / d[:, 0]
    for i in range(1, m):
        den = d[:, i] - dl[:, i] * c[:, i - 1]
        c[:, i] = du[:, i] / den
        g[:, i] = (b[:, i] - dl[:, i] * g[:, i - 1]) / den
    x = np.zeros_like(b)
    x[:, -1] = g[:, -1]
    for i in range(m - 2, -1, -1):
        x[:, i] = g[:, i] - c[:, i] * x[:, i + 1]
    return x


def _line_data_for_axis(A, dims, strides, axis, dtype):
    """Tridiagonal line systems along one grid axis (x-fastest layout)."""
    n = A.shape[0]
    m = dims[axis]
    s = strides[axis]
    idx = np.arange(n).reshape(tuple(dims[::-1]))  # (z, y, x), x fastest
    nd = len(dims)
    ax_rev = nd - 1 - axis  # position of `axis` in the reversed layout
    order = [i for i in range(nd) if i != ax_rev] + [ax_rev]
    perm = idx.transpose(order).reshape(-1, m)
    d_flat = np.asarray(A.diagonal())
    du_full = np.zeros(n)
    du_full[: n - s] = A.diagonal(s)
    dl_full = np.zeros(n)
    dl_full[s:] = A.diagonal(-s)
    d = np.where(d_flat == 0.0, 1.0, d_flat)[perm]
    du = du_full[perm]
    dl = dl_full[perm]
    du[:, -1] = 0.0
    dl[:, 0] = 0.0
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm.reshape(-1)] = np.arange(n)
    # Damping: 1/lambda_max(T^{-1} A) by host power iteration.
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    lam = 1.0
    for _ in range(30):
        y = A @ x
        y = _host_thomas(
            dl, d, du, y.reshape(-1)[perm.reshape(-1)].reshape(perm.shape)
        )
        y = y.reshape(-1)[iperm]
        lam = float(np.linalg.norm(y))
        if lam <= 0:
            return None
        x = y / lam
    omega = 1.0 / (1.05 * max(lam, 1.0))
    return LineSmoother(
        dl=jnp.asarray(dl, dtype=dtype),
        d=jnp.asarray(d, dtype=dtype),
        du=jnp.asarray(du, dtype=dtype),
        perm=jnp.asarray(perm.reshape(-1), dtype=jnp.int32),
        iperm=jnp.asarray(iperm, dtype=jnp.int32),
        omega=omega,
    )


def _build_line_smoother(A, shape, dtype):
    """Tridiagonal line relaxation along every STRONGLY-coupled grid axis
    of a structured-grid operator (x-fastest flattening, shape =
    (nx, ny, nz)): an axis engages when its mean |off-diagonal| is >= 3x
    the weakest axis's (on SPE10, y and z are jointly strong - the
    anisotropic kz cancels the geometric z-dominance - so this is
    alternating-direction line relaxation over {y, z}). Returns a tuple
    of LineSmoother (possibly empty -> None: isotropic grids keep point
    Jacobi, which is as good and cheaper)."""
    A = A.tocsr()
    dims = [s for s in shape]
    strides = [1]
    for s in dims[:-1]:
        strides.append(strides[-1] * s)
    band_mag = []
    for a in range(len(dims)):
        if dims[a] < 2:
            band_mag.append(0.0)
            continue
        band = A.diagonal(strides[a])
        band_mag.append(float(np.mean(np.abs(band))) if band.size else 0.0)
    lo = min(b for b in band_mag if b > 0) if any(b > 0 for b in band_mag) else 0.0
    if lo <= 0:
        return None
    axes = [a for a in range(len(dims)) if band_mag[a] >= 3.0 * lo]
    if not axes:
        return None
    lines = tuple(
        ln
        for ln in (
            _line_data_for_axis(A, dims, strides, a, dtype) for a in axes
        )
        if ln is not None
    )
    return lines or None


def build_mg_hierarchy(
    mats,  # list of scipy sparse per level, [0] = finest
    prolongators,  # list of scipy sparse, P[l]: level l+1 -> level l
    dtype=jnp.float32,
    omega=0.7,  # float, or "spectral" for per-level 1/lambda_max damping
    coarse_sweeps: int = 0,  # 0: dense coarsest inverse; >0: Jacobi sweeps
    line_shapes=None,  # Optional[list of per-level (nx, ny, ...) shapes]:
    # enable tridiagonal line smoothing along the strongest-coupled axis
    # on levels where one axis dominates (anisotropic structured grids)
) -> MGHierarchy:
    spectral = omega == "spectral"
    levels = []
    for l in range(len(mats) - 1):
        A = mats[l].tocsr()
        d = np.asarray(A.diagonal())
        d = np.where(d == 0.0, 1.0, d)
        dinv = 1.0 / d
        if spectral:
            # Fold the per-level damping into inv_diag (global omega = 1).
            dinv = dinv * _spectral_omega(A, dinv)
        line = None
        if line_shapes is not None:
            line = _build_line_smoother(A, line_shapes[l], dtype)
        P = prolongators[l].tocsr()
        levels.append(
            MGLevel(
                A=pack_csr_to_ell(A, dtype),
                inv_diag=jnp.asarray(dinv, dtype=dtype),
                P=pack_csr_to_ell(P, dtype),
                Pt=pack_csr_to_ell(P.T.tocsr(), dtype),
                line=line,
            )
        )
    Ac = mats[-1].tocsr()
    if coarse_sweeps > 0:
        coarse_inv = np.zeros((0, 0))
    else:
        coarse_inv = np.linalg.inv(Ac.toarray())
    dc = np.asarray(Ac.diagonal())
    dc = np.where(dc == 0.0, 1.0, dc)
    dcinv = 1.0 / dc
    if spectral and coarse_sweeps > 0:
        dcinv = dcinv * _spectral_omega(Ac, dcinv)
    return MGHierarchy(
        levels=tuple(levels),
        coarse_A=pack_csr_to_ell(Ac, dtype),
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        omega=1.0 if spectral else omega,
        coarse_inv_diag=jnp.asarray(dcinv, dtype=dtype),
        coarse_sweeps=int(coarse_sweeps),
    )


def _line_update(ln: LineSmoother, x: jnp.ndarray, r: jnp.ndarray):
    from parelagmc_tpu.ops.tridiag import solve_lines

    rl = jnp.take(r, ln.perm, axis=-1).reshape(r.shape[:-1] + ln.d.shape)
    z = solve_lines(ln.dl, ln.d, ln.du, rl).reshape(r.shape)
    return x + ln.omega * jnp.take(z, ln.iperm, axis=-1)


def _smooth(
    level: MGLevel,
    x: jnp.ndarray,
    b: jnp.ndarray,
    sweeps: int,
    omega: float,
    reverse: bool = False,
):
    lines = level.line
    if lines is not None and reverse:
        # Post-smoothing applies the line directions in reverse order so
        # the whole V-cycle is a symmetric (SPD) operator.
        lines = tuple(reversed(lines))
    for _ in range(sweeps):
        if lines is not None:
            # Damped tridiagonal block-Jacobi along each strong axis
            # (alternating-direction; batched Thomas scans).
            for ln in lines:
                r = b - ell_apply(level.A, x)
                x = _line_update(ln, x, r)
        else:
            r = b - ell_apply(level.A, x)
            x = x + omega * level.inv_diag * r
    return x


def v_cycle(
    mg: MGHierarchy, b: jnp.ndarray, sweeps: int = 2, level: int = 0
) -> jnp.ndarray:
    """One V(sweeps, sweeps) cycle applied to b (zero initial guess)."""
    if level == len(mg.levels):
        if mg.coarse_sweeps > 0:
            # Jacobi sweeps at the coarsest (config.mg_coarse_sweeps).
            x = mg.omega * mg.coarse_inv_diag * b
            for _ in range(mg.coarse_sweeps - 1):
                x = x + mg.omega * mg.coarse_inv_diag * (b - ell_apply(mg.coarse_A, x))
            return x
        # Coarsest: dense solve via batched matmul.
        return jnp.matmul(b, mg.coarse_inv.T, precision=lax.Precision.HIGHEST)
    lvl = mg.levels[level]
    x = _smooth(lvl, jnp.zeros_like(b), b, sweeps, mg.omega)
    r = b - ell_apply(lvl.A, x)
    rc = ell_apply(lvl.Pt, r)
    xc = v_cycle(mg, rc, sweeps, level + 1)
    x = x + ell_apply(lvl.P, xc)
    x = _smooth(lvl, x, b, sweeps, mg.omega, reverse=True)
    return x


def make_preconditioner(mg: MGHierarchy, sweeps: int = 2) -> Callable:
    def prec(r: jnp.ndarray) -> jnp.ndarray:
        return v_cycle(mg, r, sweeps=sweeps)

    return prec
