"""Algebraic agglomeration of a *given* unstructured mesh into MLMC levels.

The reference's core multilevel mechanism on general unstructured meshes is
ParELAG's AMGe machinery: METIS partitions the fine cell-connectivity graph
into contiguous agglomerates (/root/reference/src/Utilities.cpp:125-155
BuildTopologyAlgebraic: METIS_PartGraphKway, fixed seed, contiguous) and a
coarse de Rham sequence is built on the agglomerated topology level by level
(src/DarcySolver.cpp:161-169 Coarsen() loop). This module provides the
Device-oriented equivalent: everything here is setup-time host NumPy producing
static per-level operator bundles for the device layer (SURVEY.md section
7.1: precompute all operators on host, batch samples on device).

Coarse spaces (lowest-order AMGe, one dof per agglomerate / interface):

* Pressure: piecewise constant per agglomerate. P_l2 is the 0/1 injection
  (fine cell -> its agglomerate).
* Velocity: one dof per *coarse face* (the set of fine faces between one
  pair of agglomerates, or the fine boundary faces of one agglomerate
  sharing one boundary attribute), carrying the total flux through it.
  The coarse basis phi_F prescribes an area-weighted trace on F's fine
  faces (the Pasciak-Vassilevski interface operator) and extends into the
  two adjacent agglomerates by the minimum-energy divergence-constant
  extension: solve, per agglomerate, the local saddle problem

      min 1/2 u^T M_A u   s.t.  (B_A u)_c = sign(A,F) |c| / |A|

  over the agglomerate's interior fine faces (traces fixed on its
  boundary). This gives the exact commuting structure the reference's
  coarse sequences have:

      B_c = P_l2^T B_f P_rt  with entries exactly +-1,
      div phi_F constant per agglomerate,
      M_c = P_rt^T M_f P_rt  assembled per agglomerate so the random
      coefficient enters the coarse mass as an agglomerate-constant scale
      (the coarse analog of the fine path's element-block gathers).

Levels recurse: an AgglomeratedLevel exposes the same operator-bundle
surface as fem.simplicial.SimplicialLevel (m-ELL, cell_faces/signs,
face_cells/signs, W, bdr_attr), so it can itself be agglomerated.

The partitioner is deterministic (fixed-seed analog): cells are ordered by
the Morton code of their centroids, split into balanced contiguous chunks,
then fixed up to contiguity by connected components of the within-part
adjacency graph; undersized fragments merge into the smallest adjacent
agglomerate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from parelagmc_tpu.fem.assembly import pack_ell
from parelagmc_tpu.fem.simplicial import SimplicialLevel, build_simplicial_level
from parelagmc_tpu.fem.simplicial_hierarchy import SimplicialHierarchy
from parelagmc_tpu.mesh.mfem_io import GeneralMesh


# ---------------------------------------------------------------------------
# Partitioner (the METIS_PartGraphKway analog; deterministic, contiguous)
# ---------------------------------------------------------------------------
def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Deterministic space-filling order of points (Morton/Z-curve)."""
    x = np.asarray(centroids, dtype=np.float64)
    lo = x.min(axis=0)
    span = np.maximum(x.max(axis=0) - lo, 1e-300)
    bits = 16
    q = np.minimum(((x - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    d = x.shape[1]
    code = np.zeros(x.shape[0], dtype=np.uint64)
    for b in range(bits):
        for a in range(d):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + a)
    return np.argsort(code, kind="stable")


def partition_cells(
    cell_adj: sp.csr_matrix,
    centroids: np.ndarray,
    coarsening_factor: int,
    min_frac: float = 0.25,
) -> np.ndarray:
    """Partition cells into ~n/coarsening_factor contiguous agglomerates.

    Reference semantics: Utilities.cpp:125-155 (METIS KWAY, fixed seed,
    contiguous parts, num_partitions = nElements / coarsening_factor).
    Deterministic: Morton-ordered balanced chunks + connectivity fixup.
    """
    n = centroids.shape[0]
    factor = max(int(coarsening_factor), 2)
    order = _morton_order(centroids)

    # Greedy graph growing (contiguous by construction): seeds are taken in
    # Morton order; each part BFS-grows over unassigned neighbors until it
    # holds `factor` cells. Deterministic: FIFO frontier, neighbors visited
    # in index order.
    adj = cell_adj.tocsr()
    indptr, indices = adj.indptr, adj.indices
    labels = np.full(n, -1, dtype=np.int64)
    seed_ptr = 0
    part = 0
    from collections import deque

    while True:
        while seed_ptr < n and labels[order[seed_ptr]] >= 0:
            seed_ptr += 1
        if seed_ptr >= n:
            break
        seed = order[seed_ptr]
        frontier = deque([seed])
        labels[seed] = part
        size = 1
        while frontier and size < factor:
            c = frontier.popleft()
            for nb in indices[indptr[c] : indptr[c + 1]]:
                if labels[nb] < 0:
                    labels[nb] = part
                    frontier.append(nb)
                    size += 1
                    if size >= factor:
                        break
        part += 1
    coo = cell_adj.tocoo()

    # Merge undersized fragments into the smallest adjacent agglomerate.
    min_size = max(1, int(factor * min_frac))
    for _ in range(64):
        sizes = np.bincount(labels)
        small = np.nonzero(sizes < min_size)[0]
        if small.size == 0 or sizes.size <= 1:
            break
        la, lb = labels[coo.row], labels[coo.col]
        cross = la != lb
        moved = False
        for s in small:
            nbr = np.unique(lb[cross & (la == s)])
            nbr = nbr[nbr != s]
            if nbr.size == 0:
                continue
            tgt = nbr[np.argmin(sizes[nbr])]
            labels[labels == s] = tgt
            sizes = np.bincount(labels, minlength=sizes.size)
            moved = True
        if not moved:
            break
    # Compact label ids.
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int64)


# ---------------------------------------------------------------------------
# Agglomerated level (duck-types SimplicialLevel's operator-bundle surface)
# ---------------------------------------------------------------------------
@dataclass
class AgglomeratedLevel:
    """Operator bundle of one agglomerated coarse level.

    Cells are agglomerates; faces are agglomerate interfaces / grouped
    boundary patches. Field-for-field compatible with SimplicialLevel as
    consumed by unstructured.py (m-ELL with per-cell coefficient indices,
    signed incidences, P0 mass W, boundary attributes).
    """

    n_u: int
    n_s: int
    m_cols: np.ndarray  # (n_u, K) coefficient-ELL of the coarse RT mass
    m_vals: np.ndarray
    m_cells: np.ndarray
    cell_faces: np.ndarray  # (n_s, Kf) padded; padding slots have sign 0
    cell_signs: np.ndarray
    face_cells: np.ndarray  # (n_u, 2)
    face_signs: np.ndarray
    W: np.ndarray  # agglomerate volumes
    w_sqrt: np.ndarray
    bdr_attr: np.ndarray  # (n_u,), 0 = interior coarse face
    face_area: np.ndarray  # (n_u,) total constituent fine area
    cell_centers: np.ndarray  # (n_s, d) volume-weighted centroids

    @property
    def dim(self) -> int:
        return self.cell_centers.shape[1]

    def mass_csr(self, coeff: Optional[np.ndarray] = None) -> sp.csr_matrix:
        c = np.ones(self.n_s) if coeff is None else np.asarray(coeff, np.float64)
        rows = np.repeat(np.arange(self.n_u), self.m_cols.shape[1])
        vals = (self.m_vals * c[self.m_cells]).ravel()
        return sp.csr_matrix(
            (vals, (rows, self.m_cols.ravel())), shape=(self.n_u, self.n_u)
        )

    def b_csr(self) -> sp.csr_matrix:
        rows = np.repeat(np.arange(self.n_s), self.cell_faces.shape[1])
        return sp.csr_matrix(
            (self.cell_signs.ravel(), (rows, self.cell_faces.ravel())),
            shape=(self.n_s, self.n_u),
        )

    def ess_faces(self, ess_attr: np.ndarray) -> np.ndarray:
        ess_attr = np.asarray(ess_attr, dtype=np.int64)
        mask = np.zeros(self.n_u, dtype=bool)
        on = self.bdr_attr > 0
        idx = np.minimum(self.bdr_attr[on] - 1, len(ess_attr) - 1)
        mask[on] = ess_attr[idx] == 1
        return mask


def _level_face_areas(level: SimplicialLevel) -> np.ndarray:
    """Fine face areas (edge lengths in 2D) of a simplicial level."""
    gm = level.mesh
    d = gm.dim
    conn = np.stack(gm.elements)
    nloc = d + 1
    local_faces = [[j for j in range(nloc) if j != i] for i in range(nloc)]
    area = np.zeros(level.n_u)
    for i, lf in enumerate(local_faces):
        q = gm.vertices[conn[:, lf]]
        if d == 2:
            a = np.linalg.norm(q[:, 1] - q[:, 0], axis=1)
        else:
            a = 0.5 * np.linalg.norm(
                np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0]), axis=1
            )
        area[level.cell_faces[:, i]] = a
    return area


def _level_cell_centers(level) -> np.ndarray:
    if isinstance(level, AgglomeratedLevel):
        return level.cell_centers
    conn = np.stack(level.mesh.elements)
    return level.mesh.vertices[conn].mean(axis=1)


def _level_mass_triplets(level) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, vals, cells) COO of the level's coefficient-ELL mass."""
    K = level.m_cols.shape[1]
    rows = np.repeat(np.arange(level.n_u), K)
    cols = level.m_cols.ravel()
    vals = level.m_vals.ravel()
    cells = level.m_cells.ravel()
    keep = vals != 0.0
    return rows[keep], cols[keep], vals[keep], cells[keep]


def agglomerate_level(
    level, labels: np.ndarray, face_area: Optional[np.ndarray] = None
) -> Tuple[AgglomeratedLevel, sp.csr_matrix]:
    """Build the coarse level for a given partition. Returns
    (coarse_level, P_rt) with P_rt: (n_u_fine, n_u_coarse) such that

        M_c = P_rt^T M_f P_rt (per agglomerate),
        B_c = P_l2^T B_f P_rt (entries exactly +-1),
        W_c = P_l2^T W_f P_l2.
    """
    labels = np.asarray(labels, dtype=np.int64)
    n_agg = int(labels.max()) + 1
    n_uf, n_sf = level.n_u, level.n_s
    if face_area is None:
        face_area = (
            level.face_area
            if isinstance(level, AgglomeratedLevel)
            else _level_face_areas(level)
        )

    owner = level.face_cells[:, 0]
    second = level.face_cells[:, 1]
    is_bdr = level.face_signs[:, 1] == 0.0
    a_own = labels[owner]
    a_sec = np.where(is_bdr, -1, labels[second])

    # --- coarse faces ------------------------------------------------------
    # Interface: unordered agglomerate pair. Boundary: (agg, attr) group.
    a_lo = np.minimum(a_own, np.where(is_bdr, a_own, a_sec))
    a_hi = np.maximum(a_own, np.where(is_bdr, a_own, a_sec))
    is_iface = (~is_bdr) & (a_own != a_sec)
    key = np.stack(
        [
            np.where(is_bdr, a_own, a_lo),
            np.where(is_bdr, -1 - np.asarray(level.bdr_attr, np.int64), a_hi),
        ],
        axis=1,
    )
    active = is_iface | is_bdr
    ukey, inv = np.unique(key[active], axis=0, return_inverse=True)
    n_uc = ukey.shape[0]
    face_to_coarse = np.full(n_uf, -1, dtype=np.int64)
    face_to_coarse[active] = inv

    # Coarse orientation: a_lo -> a_hi (boundary: outward). Fine alignment:
    # the fine dof normal is outward from `owner`.
    o = np.where(is_bdr | (a_own == a_lo), 1.0, -1.0)
    coarse_area = np.zeros(n_uc)
    np.add.at(coarse_area, inv, face_area[active])
    trace = np.zeros(n_uf)
    trace[active] = (o * face_area / np.maximum(coarse_area[face_to_coarse], 1e-300))[
        active
    ]

    cu_bdr = ukey[:, 1] < 0
    cu_a = ukey[:, 0]
    cu_b = np.where(cu_bdr, -1, ukey[:, 1])
    coarse_bdr_attr = np.where(cu_bdr, -1 - ukey[:, 1], 0).astype(np.int32)

    # face_cells / face_signs for the coarse level.
    c_face_cells = np.zeros((n_uc, 2), dtype=np.int64)
    c_face_cells[:, 0] = cu_a
    c_face_cells[:, 1] = np.where(cu_bdr, 0, cu_b)
    c_face_signs = np.zeros((n_uc, 2))
    c_face_signs[:, 0] = 1.0
    c_face_signs[~cu_bdr, 1] = -1.0

    # cell_faces / cell_signs: agglomerate -> incident coarse faces.
    inc_pairs = np.concatenate(
        [np.stack([cu_a, np.arange(n_uc)], 1), np.stack([cu_b, np.arange(n_uc)], 1)[~cu_bdr]]
    )
    inc_signs = np.concatenate([np.ones(n_uc), -np.ones((~cu_bdr).sum())])
    order_inc = np.lexsort((inc_pairs[:, 1], inc_pairs[:, 0]))
    inc_pairs, inc_signs = inc_pairs[order_inc], inc_signs[order_inc]
    counts = np.bincount(inc_pairs[:, 0], minlength=n_agg)
    Kf = int(counts.max())
    c_cell_faces = np.zeros((n_agg, Kf), dtype=np.int64)
    c_cell_signs = np.zeros((n_agg, Kf))
    slot = np.arange(inc_pairs.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    c_cell_faces[inc_pairs[:, 0], slot] = inc_pairs[:, 1]
    c_cell_signs[inc_pairs[:, 0], slot] = inc_signs

    # --- per-agglomerate grouping -------------------------------------------
    W_f = np.asarray(level.W, dtype=np.float64)
    W_c = np.bincount(labels, weights=W_f, minlength=n_agg)
    cen_f = _level_cell_centers(level)
    c_centers = np.zeros((n_agg, cen_f.shape[1]))
    np.add.at(c_centers, labels, cen_f * W_f[:, None])
    c_centers /= W_c[:, None]

    cells_by_agg = np.argsort(labels, kind="stable")
    agg_starts = np.concatenate(
        [[0], np.cumsum(np.bincount(labels, minlength=n_agg))]
    )

    mr, mc, mv, mcell = _level_mass_triplets(level)
    tri_agg = labels[mcell]
    tri_order = np.argsort(tri_agg, kind="stable")
    mr, mc, mv = mr[tri_order], mc[tri_order], mv[tri_order]
    tri_starts = np.concatenate(
        [[0], np.cumsum(np.bincount(tri_agg, minlength=n_agg))]
    )

    # Fine B incidence as per-cell lists (skip padded sign-0 slots).
    cf = np.asarray(level.cell_faces, dtype=np.int64)
    cs = np.asarray(level.cell_signs, dtype=np.float64)

    # --- minimum-energy divergence-constant extensions ----------------------
    P_rows: List[np.ndarray] = []
    P_cols: List[np.ndarray] = []
    P_vals: List[np.ndarray] = []
    # Trace entries, added once per active fine face.
    P_rows.append(np.nonzero(active)[0])
    P_cols.append(face_to_coarse[active])
    P_vals.append(trace[active])

    Mc_rows: List[np.ndarray] = []
    Mc_cols: List[np.ndarray] = []
    Mc_vals: List[np.ndarray] = []
    Mc_cell: List[np.ndarray] = []

    for a in range(n_agg):
        cells = cells_by_agg[agg_starts[a] : agg_starts[a + 1]]
        # Local face set: all faces of a's cells.
        lf_all = cf[cells].ravel()
        ls_all = cs[cells].ravel()
        keep = ls_all != 0.0
        lfaces = np.unique(lf_all[keep])
        nf = lfaces.size
        # Local dense mass (assembled from a's cells only).
        s, e = tri_starts[a], tri_starts[a + 1]
        Mloc = np.zeros((nf, nf))
        li = np.searchsorted(lfaces, mr[s:e])
        lj = np.searchsorted(lfaces, mc[s:e])
        np.add.at(Mloc, (li, lj), mv[s:e])
        # Local B (cells x faces).
        nc = cells.size
        Bloc = np.zeros((nc, nf))
        for ci, c in enumerate(cells):
            f_row = cf[c]
            s_row = cs[c]
            nz = s_row != 0.0
            Bloc[ci, np.searchsorted(lfaces, f_row[nz])] = s_row[nz]
        # Interior faces: both adjacent cells in a (equivalently: fine faces
        # that are not part of any coarse face, restricted to a).
        cF = face_to_coarse[lfaces]
        # A fine face of cell(s) of a is a trace face iff it is active AND
        # the coarse face it belongs to is incident to a.
        interior = cF < 0
        # Faces active but belonging to a coarse face between two OTHER
        # agglomerates can't occur (any face of a's cells touches a).
        bmask = ~interior
        ii = np.nonzero(interior)[0]
        bb = np.nonzero(bmask)[0]
        inc_cF = np.unique(cF[bb])
        # Trace vectors for each incident coarse face (columns).
        T = np.zeros((bb.size, inc_cF.size))
        for k, F in enumerate(inc_cF):
            selb = cF[bb] == F
            T[selb, k] = trace[lfaces[bb[selb]]]
        # Coarse sign of each incident F seen from a (+1 = leaves a).
        sF = np.where(cu_a[inc_cF] == a, 1.0, -1.0)
        # Divergence targets: (B u)_c = sF * |c| / |A|.
        vols = W_f[cells]
        Dv = (vols[:, None] / W_c[a]) * sF[None, :]

        ni = ii.size
        if ni > 0:
            Mii = Mloc[np.ix_(ii, ii)]
            Mib = Mloc[np.ix_(ii, bb)]
            Bi = Bloc[:, ii]
            Bb = Bloc[:, bb]
            rhs_u = -Mib @ T
            rhs_p = Dv - Bb @ T
            # Ground the last cell's multiplier (compatible by construction;
            # B_i^T 1 = 0 on a connected agglomerate).
            K = np.block(
                [
                    [Mii, Bi[:-1].T],
                    [Bi[:-1], np.zeros((nc - 1, nc - 1))],
                ]
            )
            rhs = np.concatenate([rhs_u, rhs_p[:-1]], axis=0)
            try:
                sol = np.linalg.solve(K, rhs)
            except np.linalg.LinAlgError as err:
                raise ValueError(
                    f"singular local extension on agglomerate {a} "
                    f"(disconnected agglomerate?): {err}"
                ) from None
            U = sol[:ni]  # (ni, n_incident)
            P_rows.append(np.repeat(lfaces[ii], inc_cF.size))
            P_cols.append(np.tile(inc_cF, ni))
            P_vals.append(U.ravel())
        else:
            U = np.zeros((0, inc_cF.size))

        # Local coarse mass block: P_a^T M_a P_a over incident coarse faces.
        Ploc = np.zeros((nf, inc_cF.size))
        if ni > 0:
            Ploc[ii] = U
        Ploc[bb] = T
        Gc = Ploc.T @ Mloc @ Ploc
        kk = inc_cF.size
        Mc_rows.append(np.repeat(inc_cF, kk))
        Mc_cols.append(np.tile(inc_cF, kk))
        Mc_vals.append(Gc.ravel())
        Mc_cell.append(np.full(kk * kk, a, dtype=np.int64))

    P_rt = sp.csr_matrix(
        (
            np.concatenate(P_vals),
            (np.concatenate(P_rows), np.concatenate(P_cols)),
        ),
        shape=(n_uf, n_uc),
    )
    P_rt.sum_duplicates()

    m_cols, m_vals, m_cells = pack_ell(
        np.concatenate(Mc_rows),
        np.concatenate(Mc_cols),
        np.concatenate(Mc_vals),
        n_uc,
        cells=np.concatenate(Mc_cell),
    )

    coarse = AgglomeratedLevel(
        n_u=n_uc,
        n_s=n_agg,
        m_cols=m_cols,
        m_vals=m_vals,
        m_cells=m_cells,
        cell_faces=c_cell_faces,
        cell_signs=c_cell_signs,
        face_cells=c_face_cells,
        face_signs=c_face_signs,
        W=W_c,
        w_sqrt=np.sqrt(W_c),
        bdr_attr=coarse_bdr_attr,
        face_area=coarse_area,
        cell_centers=c_centers,
    )
    return coarse, P_rt


def _cell_adjacency(level) -> sp.csr_matrix:
    """Cell-connectivity graph through interior faces."""
    interior = level.face_signs[:, 1] != 0.0
    r = level.face_cells[interior, 0]
    c = level.face_cells[interior, 1]
    n = level.n_s
    return sp.csr_matrix(
        (np.ones(2 * r.size), (np.concatenate([r, c]), np.concatenate([c, r]))),
        shape=(n, n),
    )


def build_agglomerated_hierarchy(
    gm: GeneralMesh,
    nlevels: int,
    coarsening_factor: int = 8,
) -> SimplicialHierarchy:
    """MLMC hierarchy by recursive agglomeration of a *given* fine mesh -
    the reference's workflow for arbitrary unstructured meshes
    (Utilities.cpp:125-155 + DarcySolver.cpp:161-169), vs
    build_simplicial_hierarchy which refines a coarse mesh. `gm` is the
    FINEST level (level 0)."""
    fine = build_simplicial_level(gm)
    levels: List = [fine]
    parents: List[np.ndarray] = []
    P_rt: List[sp.csr_matrix] = []
    for _ in range(nlevels - 1):
        lvl = levels[-1]
        labels = partition_cells(
            _cell_adjacency(lvl), _level_cell_centers(lvl), coarsening_factor
        )
        coarse, P = agglomerate_level(lvl, labels)
        levels.append(coarse)
        parents.append(labels)
        P_rt.append(P)
    return SimplicialHierarchy(levels=levels, parent=parents, P_rt=P_rt)
