"""Exact batched solves with the RT0 velocity mass matrix on tensor grids.

On axis-aligned tensor-product meshes the RT0 mass matrix is block-diagonal
per axis, and within each axis it decouples into independent *tridiagonal*
systems along grid lines (cross-axis RT0 products vanish; see
fem/assembly.py). For a piecewise-constant coefficient w the line systems
have per-cell coefficients

    d[face i]  = w[i-1]*m3[i-1] + w[i]*m3[i],   m3 = h^2/(3V)
    off[i,i+1] = w[i]*m6[i],                    m6 = h^2/(6V)

(one-sided at boundaries), so M(w)^{-1} is applied *exactly* per sample by
batched tridiagonal line solves (ops/tridiag.py). This unlocks the exact
pressure Schur-complement CG for the Darcy problem (physics/darcy.py "cg-schur"): the reference needs AMG
preconditioners because its meshes are unstructured; on tensor grids the
velocity block is directly invertible.

Essential velocity dofs are eliminated to identity rows and their couplings
zeroed, matching the masked operators used elsewhere.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from parelagmc_tpu.fem.assembly import MixedLevel
from parelagmc_tpu.ops.tridiag import prepare_lines, resolve_route, solve_prepared


class _AxisData(NamedTuple):
    # Per-cell tridiagonal coefficient tables, cell grid with the solved
    # axis last: (lines..., n_a). Cell i contributes m_lo[i] to the diagonal
    # of its lo face, m_hi[i] to its hi face and m_mid[i] to their coupling.
    # Rediscretized levels have m_lo == m_hi == h^2/(3V)*kinv and
    # m_mid == h^2/(6V)*kinv; Galerkin-coarsened levels carry the general
    # RAP blocks (fem/galerkin_mass.py), where lo/hi differ.
    m_lo: jnp.ndarray
    m_mid: jnp.ndarray
    m_hi: jnp.ndarray
    ess: jnp.ndarray  # face grid, axis last: (lines..., n_a + 1) bool
    n_a: int  # cells along the axis
    perm_cell: Tuple[int, ...]  # reversed-grid dims -> (lines..., axis)
    perm_face: Tuple[int, ...]


def build_line_tables(m_lo, m_mid, m_hi, ess, w, ess_prev=None, ess_next=None):
    """(dl, diag, du) for the tridiagonal mass lines along the LAST axis:
    per-cell blocks (m_lo, m_mid, m_hi) scaled by the sample coefficient w
    (cells along the last axis; the face grid has one more entry), with
    essential rows replaced by identity and couplings into essential
    neighbors zeroed. ess_prev/ess_next default to the local roll;
    shard-distributed callers pass halo-aware masks
    (parallel/spatial_darcy.py). Shared by MassTridiagSolver.factor and
    the spatially-sharded solver so the masking rules cannot drift."""
    c_lo = w * m_lo
    c_mid = w * m_mid
    c_hi = w * m_hi
    zero = jnp.zeros_like(c_lo[..., :1])
    diag = jnp.concatenate([c_lo, zero], axis=-1) + jnp.concatenate(
        [zero, c_hi], axis=-1
    )
    du = jnp.concatenate([c_mid, zero], axis=-1)  # couples (i, i+1)
    dl = jnp.concatenate([zero, c_mid], axis=-1)  # couples (i, i-1)
    if ess_next is None:
        ess_next = jnp.concatenate([ess[..., 1:], ess[..., :1]], axis=-1)
    if ess_prev is None:
        ess_prev = jnp.concatenate([ess[..., -1:], ess[..., :-1]], axis=-1)
    diag = jnp.where(ess, 1.0, diag)
    du = jnp.where(ess | ess_next, 0.0, du)
    dl = jnp.where(ess | ess_prev, 0.0, dl)
    return dl, diag, du


class MassTridiagSolver(NamedTuple):
    axes: Tuple[_AxisData, ...]
    shape: Tuple[int, ...]  # cells per mesh axis (x first)
    face_offsets: Tuple[int, ...]
    n_u: int

    def __call__(self, w: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
        """z = M(w)^{-1} rhs, batched over leading dims of w/rhs."""
        return self.apply_factored(self.factor(w), rhs)

    def factor(self, w: jnp.ndarray):
        """Per-axis tridiagonal tables (dl, diag, du) in line layout for the
        sample coefficient `w` (batched over leading dims).

        Factor ONCE per Krylov solve and reuse via apply_factored: the
        tables depend only on w, and XLA does not hoist their construction
        out of a lax.while_loop body. The line-solve route is resolved from
        the per-sample cell count (ops/tridiag.resolve_route), so every
        batch size of one level takes the same route.
        """
        d = len(self.shape)
        batch = w.shape[:-1]
        nb = len(batch)
        wg = w.reshape(batch + tuple(self.shape[::-1]))  # (..., z, y, x)
        route = resolve_route(int(np.prod(self.shape)), w.dtype)
        factors = []
        for a in range(d):
            ax = self.axes[a]
            w_a = jnp.transpose(wg, tuple(range(nb)) + tuple(nb + p for p in ax.perm_cell))
            factors.append(prepare_lines(
                *build_line_tables(ax.m_lo, ax.m_mid, ax.m_hi, ax.ess, w_a),
                route,
            ))
        return tuple(factors)

    def apply_factored(self, factors, rhs: jnp.ndarray) -> jnp.ndarray:
        """z = M^{-1} rhs for tables built by factor() (same batch dims)."""
        d = len(self.shape)
        batch = rhs.shape[:-1]
        nb = len(batch)
        outs = []
        for a in range(d):
            ax = self.axes[a]
            fshape = list(self.shape)
            fshape[a] += 1
            r = rhs[..., self.face_offsets[a]: self.face_offsets[a + 1]]
            r = r.reshape(batch + tuple(fshape[::-1]))
            r = jnp.transpose(r, tuple(range(nb)) + tuple(nb + p for p in ax.perm_face))
            z = solve_prepared(factors[a], r)
            inv = np.argsort(ax.perm_face)
            z = jnp.transpose(z, tuple(range(nb)) + tuple(nb + p for p in inv))
            outs.append(z.reshape(batch + (-1,)))
        return jnp.concatenate(outs, axis=-1)


def build_mass_tridiag_solver(
    lvl: MixedLevel,
    ess_mask: np.ndarray,
    kinv_ref: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    axis_blocks=None,
) -> MassTridiagSolver:
    """Static factors for M(w)^{-1} on `lvl`'s mesh with essential dofs
    `ess_mask`. Either fold an optional static per-axis inverse permeability
    (n_s, d) into the rediscretized coefficients (matching DarcySolver's
    baked kinv_ref), or take general per-cell (bll, blr, brr) Galerkin
    blocks (fem/galerkin_mass.py) via `axis_blocks` - the energy-consistent
    coarse levels stay exactly line-tridiagonal, so the exact batched
    M(w)^{-1} survives the Galerkin coarsening unchanged."""
    mesh = lvl.mesh
    d = mesh.dim
    shape = mesh.shape
    vol = mesh.cell_volumes().reshape(shape[::-1])  # (z, y, x)
    axes: List[_AxisData] = []
    for a in range(d):
        if axis_blocks is not None:
            bll, blr, brr = axis_blocks
            m_lo = bll[:, a].reshape(shape[::-1])
            m_mid = blr[:, a].reshape(shape[::-1])
            m_hi = brr[:, a].reshape(shape[::-1])
        else:
            h = mesh.cell_widths(a).reshape(shape[::-1])
            m_lo = h * h / (3.0 * vol)
            m_mid = 0.5 * m_lo
            if kinv_ref is not None:
                k = np.asarray(kinv_ref)
                ka = (k[:, a] if k.ndim == 2 else k).reshape(shape[::-1])
                m_lo = m_lo * ka
                m_mid = m_mid * ka
            m_hi = m_lo
        # Array layout is (z, y, x); mesh axis a is array dim d-1-a. Move it
        # last.
        dim_a = d - 1 - a
        perm_cell = tuple(i for i in range(d) if i != dim_a) + (dim_a,)
        m_lo = np.transpose(m_lo, perm_cell)
        m_mid = np.transpose(m_mid, perm_cell)
        m_hi = np.transpose(m_hi, perm_cell)
        fshape = list(shape)
        fshape[a] += 1
        ess_a = ess_mask[mesh.face_offsets[a]: mesh.face_offsets[a + 1]].reshape(
            tuple(fshape[::-1])
        )
        ess_a = np.transpose(ess_a, perm_cell)
        axes.append(
            _AxisData(
                m_lo=jnp.asarray(m_lo, dtype=dtype),
                m_mid=jnp.asarray(m_mid, dtype=dtype),
                m_hi=jnp.asarray(m_hi, dtype=dtype),
                ess=jnp.asarray(ess_a),
                n_a=shape[a],
                perm_cell=perm_cell,
                perm_face=perm_cell,
            )
        )
    return MassTridiagSolver(
        axes=tuple(axes),
        shape=shape,
        face_offsets=tuple(int(x) for x in mesh.face_offsets),
        n_u=lvl.n_u,
    )
