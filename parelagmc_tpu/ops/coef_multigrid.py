"""Per-sample Galerkin multigrid on the pressure Schur complement.

The reference rebuilds its AMG preconditioner from the actual sampled
coefficient on every solve (hypre BoomerAMG setup per sample,
src/DarcySolver.cpp:562-649 of the reference). The static-hierarchy
analog (ops/multigrid.py built on kinv_ref only, sample entering through a
global or per-cell scale) measurably under-preconditions rough lognormal
samples. This module closes that gap with static device tables: the ENTIRE coefficient
dependence of the MG hierarchy reduces to static gather tables applied to
one per-sample face vector.

Key identity: with lowest-order RT0/P0 and a diagonal velocity-mass
approximation, the pressure Schur complement is the face-form operator

    S(w)[c, c'] = sum_f B[c,f] dinv_f(w) B[c',f],
    dinv_f(w)   = 1 / diag(M(w * kinv))_f,

and Galerkin coarsening with piecewise-constant aggregation P collapses
EXACTLY to the same face-form operator on the coarse mesh with

    dinv_F(w) = sum_{fine f crossing F} dinv_f(w)

(faces interior to an agglomerate cancel; parallel crossing faces add).
So one batched (batch, n_faces) vector per level - produced by a static
padded gather-sum from the level above - IS the per-sample Galerkin
hierarchy: per-sample smoother diagonals and coarse operators at gather
cost, no assembly, no setup phase on device.

All index tables are built on host at setup (CLAUDE.md convention); the
device side is pure gathers + elementwise work. The V-cycle uses damped
Jacobi smoothing with the per-sample diagonal (symmetric pre/post, fixed
omega < 2/lambda_max: for these M-matrix stencils lambda_max(D^-1 S) < 2,
so omega = 0.8 keeps the cycle an SPD preconditioner).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np


class CoefMGLevel(NamedTuple):
    # Face-form operator tables in THIS level's numbering.
    cell_faces: jnp.ndarray  # (n_c, 2d) int32, padded with 0
    cell_signs: jnp.ndarray  # (n_c, 2d), 0.0 on padding
    face_cells: jnp.ndarray  # (n_f, 2) int32
    face_signs: jnp.ndarray  # (n_f, 2), 0.0 on padding / boundary
    # Aggregation from the PREVIOUS (finer) level; None on level 0.
    face_src: object = None  # (n_f, K) int32 fine-face ids
    face_src_mask: object = None  # (n_f, K)
    parent: object = None  # (n_c_prev,) int32 fine cell -> this level's cell
    cell_src: object = None  # (n_c, Kc) int32 fine-cell ids
    cell_src_mask: object = None  # (n_c, Kc)


class CoefMG(NamedTuple):
    levels: Tuple[CoefMGLevel, ...]
    omega: float
    coarse_sweeps: int
    # Smoother: 0 = damped Jacobi (omega), k > 0 = order-k Chebyshev
    # accelerated Jacobi on the interval [cheby_lo * 2, 2] of D^{-1} S
    # (lambda_max(D^{-1}S) < 2 for these M-matrix stencils; see module
    # docstring). Same operator applications per sweep as Jacobi, far
    # stronger damping of the upper spectrum - the standard
    # accelerator-era MG smoother (hypre/AMGX default).
    cheby_order: int = 0
    cheby_lo: float = 0.25


# -- host construction --------------------------------------------------------


def _pad_table(dst_ids: np.ndarray, src_ids: np.ndarray, n_dst: int):
    """Invert a src->dst map into a padded (n_dst, K) gather table."""
    order = np.argsort(dst_ids, kind="stable")
    dst_s = dst_ids[order]
    src_s = src_ids[order]
    counts = np.bincount(dst_s, minlength=n_dst)
    K = max(1, int(counts.max()) if counts.size else 1)
    table = np.zeros((n_dst, K), dtype=np.int32)
    mask = np.zeros((n_dst, K), dtype=np.float64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(dst_s.size) - starts[dst_s]
    table[dst_s, slot] = src_s
    mask[dst_s, slot] = 1.0
    return table, mask


def _face_map(fine, coarse) -> np.ndarray:
    """(n_fine_faces,) coarse face id for each fine face, -1 when the fine
    face is interior to a coarse cell (dropped by Galerkin cancellation).
    Coarse grid lines must be a value-subset of fine ones (derefine_axis)."""
    from parelagmc_tpu.fem.hierarchy import axis_parent_map

    d = fine.dim
    cmaps = [axis_parent_map(fine.axes[a], coarse.axes[a]) for a in range(d)]
    out = np.full(int(fine.face_offsets[-1]), -1, dtype=np.int64)
    for a in range(d):
        fshape = fine.face_grid_shape(a)
        grids = np.meshgrid(*[np.arange(s) for s in fshape], indexing="ij")
        plane = fine.axes[a][grids[a]]
        j = np.searchsorted(coarse.axes[a], plane)
        j = np.clip(j, 0, coarse.axes[a].size - 1)
        on = np.isclose(coarse.axes[a][j], plane)
        cidx = [
            j if x == a else cmaps[x][grids[x]] for x in range(d)
        ]
        fine_ids = fine.face_index(a, *grids)
        coarse_ids = coarse.face_index(a, *cidx)
        out[fine_ids[on]] = coarse_ids[on]
    return out


def build_coef_mg(
    mesh,
    ess_faces: np.ndarray,
    dtype=jnp.float32,
    cutoff: int = 5000,
    coarse_sweeps: int = 8,
    omega: float = 0.8,
    cheby_order: int = 0,
    cheby_lo: float = 0.25,
) -> CoefMG:
    """Static index tables for the per-sample Galerkin Schur MG below the
    given (MLMC-level) mesh. The per-sample values enter at apply time as
    dinv0 (see coef_mg_dinvs); kinv/ess masking lives in dinv0's
    definition (DarcySolver passes its masked mass diagonal)."""
    from parelagmc_tpu.fem.assembly import build_mixed_level
    from parelagmc_tpu.fem.hierarchy import axis_parent_map, derefine_axis
    from parelagmc_tpu.mesh.structured import StructuredMesh

    meshes = [mesh]
    while meshes[-1].num_cells > cutoff and max(meshes[-1].shape) > 2:
        meshes.append(
            StructuredMesh([derefine_axis(a) for a in meshes[-1].axes])
        )

    levels = []
    for l, m in enumerate(meshes):
        lvl = build_mixed_level(m)
        cell_signs = lvl.cell_signs.copy()
        face_signs = lvl.face_signs.copy()
        if l == 0:
            # Essential faces drop out of S (their dinv is 0 in the masked
            # mass diagonal); zero their signs too so padding stays inert.
            face_signs[ess_faces, :] = 0.0
            cell_signs = np.where(ess_faces[lvl.cell_faces], 0.0, cell_signs)
            extra = {}
        else:
            fine_m = meshes[l - 1]
            fmap = _face_map(fine_m, m)
            valid = fmap >= 0
            face_src, face_mask = _pad_table(
                fmap[valid],
                np.nonzero(valid)[0].astype(np.int64),
                int(m.face_offsets[-1]),
            )
            d = fine_m.dim
            cmaps = [
                axis_parent_map(fine_m.axes[a], m.axes[a]) for a in range(d)
            ]
            idx = fine_m.cell_multi_index()
            par = m.cell_index(*[cm[i] for cm, i in zip(cmaps, idx)])
            cell_src, cell_mask = _pad_table(
                par, np.arange(fine_m.num_cells, dtype=np.int64), m.num_cells
            )
            extra = dict(
                face_src=jnp.asarray(face_src, dtype=jnp.int32),
                face_src_mask=jnp.asarray(face_mask, dtype=dtype),
                parent=jnp.asarray(par, dtype=jnp.int32),
                cell_src=jnp.asarray(cell_src, dtype=jnp.int32),
                cell_src_mask=jnp.asarray(cell_mask, dtype=dtype),
            )
        levels.append(
            CoefMGLevel(
                cell_faces=jnp.asarray(lvl.cell_faces, dtype=jnp.int32),
                cell_signs=jnp.asarray(cell_signs, dtype=dtype),
                face_cells=jnp.asarray(lvl.face_cells, dtype=jnp.int32),
                face_signs=jnp.asarray(face_signs, dtype=dtype),
                **extra,
            )
        )
    return CoefMG(
        levels=tuple(levels),
        omega=float(omega),
        coarse_sweeps=int(coarse_sweeps),
        cheby_order=int(cheby_order),
        cheby_lo=float(cheby_lo),
    )


def _invert_face_cells(face_cells, face_signs, n_cells):
    """Padded (n_c, K) cell->faces tables from (n_f, 2) face incidence."""
    two = (face_signs != 0.0).reshape(-1)
    faces = np.repeat(np.arange(face_cells.shape[0]), 2)[two]
    cells = face_cells.reshape(-1)[two]
    signs = face_signs.reshape(-1)[two]
    table, mask = _pad_table(cells.astype(np.int64), faces.astype(np.int64), n_cells)
    # Rebuild the sign table aligned with `table` slots.
    sign_tab = np.zeros_like(mask)
    order = np.argsort(cells, kind="stable")
    counts = np.bincount(cells, minlength=n_cells)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(cells.size) - starts[cells[order]]
    sign_tab[cells[order], slot] = signs[order]
    return table, sign_tab * mask


def build_coef_mg_graph(
    face_cells: np.ndarray,
    face_signs: np.ndarray,
    centroids: np.ndarray,
    dtype=jnp.float32,
    cutoff: int = 2000,
    factor: int = 8,
    coarse_sweeps: int = 8,
    omega: float = 0.8,
) -> CoefMG:
    """CoefMG for ANY cell complex, from face incidence alone: MG levels
    come from greedy graph agglomeration (fem.agglomeration.partition_cells,
    the METIS analog), and the Galerkin identity from the module docstring
    applies verbatim - interior faces of an agglomerate cancel, parallel
    crossing faces add their dinv. This is the unstructured/AMGe variant:
    it serves simplicial, agglomerated and curved meshes (the reference's
    per-sample BoomerAMG analog without any mesh structure assumption).

    face_signs must already carry essential-BC masking (rows zeroed);
    interior faces carry opposite unit signs (divergence incidence)."""
    import scipy.sparse as sp

    from parelagmc_tpu.fem.agglomeration import partition_cells

    face_cells = np.asarray(face_cells, dtype=np.int64)
    face_signs = np.asarray(face_signs, dtype=np.float64)
    n_c = int(centroids.shape[0])

    def level_tables(fc, fs, n_cells, extra):
        cf, cs = _invert_face_cells(fc, fs, n_cells)
        return CoefMGLevel(
            cell_faces=jnp.asarray(cf, dtype=jnp.int32),
            cell_signs=jnp.asarray(cs, dtype=dtype),
            face_cells=jnp.asarray(np.maximum(fc, 0), dtype=jnp.int32),
            face_signs=jnp.asarray(fs, dtype=dtype),
            **extra,
        )

    levels = [level_tables(face_cells, face_signs, n_c, {})]
    fc, fs, cents = face_cells, face_signs, np.asarray(centroids, dtype=np.float64)
    while n_c > cutoff:
        # Adjacency from two-sided faces.
        two = (fs[:, 0] != 0.0) & (fs[:, 1] != 0.0)
        rows = fc[two, 0]
        cols = fc[two, 1]
        adj = sp.csr_matrix(
            (np.ones(2 * rows.size), (np.r_[rows, cols], np.r_[cols, rows])),
            shape=(n_c, n_c),
        )
        labels = partition_cells(adj, cents, factor)
        n_C = int(labels.max()) + 1
        if n_C >= n_c:  # no progress (tiny or disconnected): stop
            break
        # Group faces by coarse pair; drop agglomerate-interior faces.
        C0 = np.where(fs[:, 0] != 0.0, labels[fc[:, 0]], -1)
        C1 = np.where(fs[:, 1] != 0.0, labels[fc[:, 1]], -1)
        lo = np.minimum(C0, C1)
        hi = np.maximum(C0, C1)
        keep = (hi >= 0) & ((lo != hi)) & ~((lo >= 0) & (lo == hi))
        # (lo == -1, hi >= 0): boundary group; (lo != hi >= 0): crossing.
        key = hi[keep] * (n_C + 1) + (lo[keep] + 1)
        uniq, inv = np.unique(key, return_inverse=True)
        n_F = uniq.size
        src_ids = np.nonzero(keep)[0].astype(np.int64)
        face_src, face_mask = _pad_table(inv.astype(np.int64), src_ids, n_F)
        new_fc = np.zeros((n_F, 2), dtype=np.int64)
        new_fs = np.zeros((n_F, 2), dtype=np.float64)
        u_hi = uniq // (n_C + 1)
        u_lo = uniq % (n_C + 1) - 1
        new_fc[:, 0] = u_hi
        new_fs[:, 0] = 1.0
        bdry = u_lo < 0
        new_fc[~bdry, 1] = u_lo[~bdry]
        new_fs[~bdry, 1] = -1.0
        cell_src, cell_mask = _pad_table(
            labels.astype(np.int64), np.arange(n_c, dtype=np.int64), n_C
        )
        extra = dict(
            face_src=jnp.asarray(face_src, dtype=jnp.int32),
            face_src_mask=jnp.asarray(face_mask, dtype=dtype),
            parent=jnp.asarray(labels, dtype=jnp.int32),
            cell_src=jnp.asarray(cell_src, dtype=jnp.int32),
            cell_src_mask=jnp.asarray(cell_mask, dtype=dtype),
        )
        levels.append(level_tables(new_fc, new_fs, n_C, extra))
        # Coarse centroids: mean of member centroids.
        sums = np.zeros((n_C, cents.shape[1]))
        np.add.at(sums, labels, cents)
        cents = sums / np.bincount(labels, minlength=n_C)[:, None]
        fc, fs, n_c = new_fc, new_fs, n_C
    return CoefMG(
        levels=tuple(levels), omega=float(omega), coarse_sweeps=int(coarse_sweeps)
    )


# -- device apply -------------------------------------------------------------


def _gather_sum(vals, idx, mask):
    g = jnp.take(vals, idx.reshape(-1), axis=-1).reshape(
        vals.shape[:-1] + idx.shape
    )
    return jnp.sum(g * mask, axis=-1)


def coef_mg_dinvs(mg: CoefMG, dinv0: jnp.ndarray):
    """Per-level (batch, n_faces_l) face vectors - the whole per-sample
    Galerkin hierarchy. Compute ONCE per solve, outside the Krylov loop."""
    dinvs = [dinv0]
    for lvl in mg.levels[1:]:
        dinvs.append(_gather_sum(dinvs[-1], lvl.face_src, lvl.face_src_mask))
    return dinvs


def _s_apply(lvl: CoefMGLevel, dinv, x):
    x0 = jnp.take(x, lvl.face_cells[:, 0], axis=-1)
    x1 = jnp.take(x, lvl.face_cells[:, 1], axis=-1)
    t = dinv * (lvl.face_signs[:, 0] * x0 + lvl.face_signs[:, 1] * x1)
    g = jnp.take(t, lvl.cell_faces.reshape(-1), axis=-1).reshape(
        t.shape[:-1] + lvl.cell_faces.shape
    )
    return jnp.sum(g * lvl.cell_signs, axis=-1)


def _jacobi_diag(lvl: CoefMGLevel, dinv):
    g = jnp.take(dinv, lvl.cell_faces.reshape(-1), axis=-1).reshape(
        dinv.shape[:-1] + lvl.cell_faces.shape
    )
    diag = jnp.sum(g * lvl.cell_signs ** 2, axis=-1)
    return jnp.where(diag > 0, diag, 1.0)


def _cheb_smooth(mg: CoefMG, lvl: CoefMGLevel, dinv, idiag, b, x):
    """Order-k Chebyshev(Jacobi) smoothing sweep for x ~ S^{-1} b on the
    spectral window [cheby_lo * 2, 2] of D^{-1} S (Saad alg. 12.1 with the
    diagonal preconditioner folded in). Self-adjoint in the S inner
    product - a fixed polynomial p(D^{-1}S) D^{-1} with symmetric D - so
    the V-cycle stays an SPD preconditioner for CG. Pass x=None for a
    zero initial iterate (saves one operator application)."""
    lam_max = 2.0
    lam_min = mg.cheby_lo * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    if x is None:
        r = b
        x = jnp.zeros_like(b)
    else:
        r = b - _s_apply(lvl, dinv, x)
    d = (1.0 / theta) * idiag * r
    for _ in range(mg.cheby_order - 1):
        x = x + d
        r = r - _s_apply(lvl, dinv, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (idiag * r)
        rho = rho_new
    return x + d


def coef_mg_idiags(mg: CoefMG, dinvs):
    """Per-level inverse Jacobi diagonals. Like the dinvs, these depend
    only on the sample coefficient: compute ONCE per solve and pass to
    coef_v_cycle - XLA does not hoist the (loop-invariant) gather chain
    out of a Krylov while_loop body."""
    return [1.0 / _jacobi_diag(lvl, dv) for lvl, dv in zip(mg.levels, dinvs)]


def coef_v_cycle(mg: CoefMG, dinvs, b, sweeps: int = 2, level: int = 0,
                 idiags=None):
    """One V(sweeps, sweeps) cycle with the per-sample hierarchy (Jacobi
    smoothing), or V(cheby_order, cheby_order) when mg.cheby_order > 0."""
    lvl = mg.levels[level]
    dinv = dinvs[level]
    idiag = (1.0 / _jacobi_diag(lvl, dinv)) if idiags is None else idiags[level]
    cheby = mg.cheby_order > 0
    if level == len(mg.levels) - 1:
        x = mg.omega * idiag * b
        for _ in range(mg.coarse_sweeps - 1):
            x = x + mg.omega * idiag * (b - _s_apply(lvl, dinv, x))
        return x
    if cheby:
        x = _cheb_smooth(mg, lvl, dinv, idiag, b, None)
    else:
        # First pre-sweep from x = 0 in closed form (skips one operator
        # application per level per cycle; advisor finding r2).
        x = mg.omega * idiag * b
        for _ in range(sweeps - 1):
            x = x + mg.omega * idiag * (b - _s_apply(lvl, dinv, x))
    r = b - _s_apply(lvl, dinv, x)
    nxt = mg.levels[level + 1]
    rc = _gather_sum(r, nxt.cell_src, nxt.cell_src_mask)
    xc = coef_v_cycle(mg, dinvs, rc, sweeps, level + 1, idiags)
    x = x + jnp.take(xc, nxt.parent, axis=-1)
    if cheby:
        return _cheb_smooth(mg, lvl, dinv, idiag, b, x)
    for _ in range(sweeps):
        x = x + mg.omega * idiag * (b - _s_apply(lvl, dinv, x))
    return x
