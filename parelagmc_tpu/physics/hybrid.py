"""Hybridized mixed Darcy solves on simplicial meshes: the SPD fast path.

The reference's fast unstructured configuration hybridizes the saddle
system - element-local flux/pressure unknowns coupled by face Lagrange
multipliers - then runs PCG on the SPD multiplier system, rescaling the
element matrices by the sample coefficient instead of re-assembling
(/root/reference/src/DarcySolver.cpp:562-649, element rescaling :586-591).
Round 2's unstructured stack only had MINRES on the full saddle system -
the slowest solver family in the repo (VERDICT r2 item 6 / next-6).

Batched formulation. With one pressure per element and constant
per-element coefficient w_e, the element blocks scale EXACTLY:

    local saddle  [[w_e M_e, b_e], [b_e^T, 0]]
    =>  flux-flux block of its inverse  A_e(w) = (1/w_e) A_e^unit,
        A^unit = M^-1 - M^-1 b (b^T M^-1 b)^-1 b^T M^-1,

so the condensed multiplier operator is a per-element-coefficient batched
small matmul,

    H(w) = sum_e C_e (1/w_e) A_e^unit C_e^T,

applied as gather -> (ne, nloc, nloc) einsum -> two-slot
gather-sum - the same static-sparsity pattern philosophy as CoefELL, with
the per-sample "assembly" being one elementwise 1/w. PCG with the Jacobi
diag(H(w)) preconditioner; element-local recovery of (u, p~) and the QoI.

Conventions match physics/darcy.py: p~ = -p, system signs [[M, B^T],
[B, 0]], essential faces carry u.n = 0 (slots masked out), natural
pressure data arrives pre-assembled in the velocity rhs (nonzero only on
boundary faces, so the per-element distribution f_e = sign * rhs_u[face]
never double-counts).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from parelagmc_tpu.ops.solvers import pcg


def element_outward_mass(gm) -> np.ndarray:
    """(ne, d+1, d+1) RT0 element mass matrices in the element-OUTWARD flux
    basis (phi_i = (x - p_i) / (d |K|): unit outward flux through face i,
    sign-free - the owner-orientation signs of the assembled basis cancel
    in this basis)."""
    from parelagmc_tpu.fem.simplicial import _simplex_quadrature

    conn = np.stack(gm.elements)
    d = gm.dim
    nloc = d + 1
    p = gm.vertices[conn]  # (ne, nloc, d)
    mats = p[:, 1:, :] - p[:, :1, :]
    vol = np.abs(np.linalg.det(mats)) / math.factorial(d)
    bary, wq = _simplex_quadrature(d)
    xq = np.einsum("qi,eid->eqd", bary, p)
    Mt = np.zeros((conn.shape[0], nloc, nloc))
    inv_dv = 1.0 / (d * vol)
    phis = [
        inv_dv[:, None, None] * (xq - p[:, i, None, :]) for i in range(nloc)
    ]
    for i in range(nloc):
        for j in range(i, nloc):
            val = vol * np.einsum("q,eqd,eqd->e", wq, phis[i], phis[j])
            Mt[:, i, j] = val
            Mt[:, j, i] = val
    return Mt


class HybridLevel(NamedTuple):
    n_lam: int
    n_s: int
    nloc: int
    A_unit: jnp.ndarray  # (ne, nloc, nloc) unit flux-flux inverse block
    r_til: jnp.ndarray  # (ne, nloc) pressure-recovery row M^-1 b / (b^T M^-1 b)
    s_den: jnp.ndarray  # (ne,) b^T M^-1 b
    c_idx: jnp.ndarray  # (ne, nloc) int32 multiplier id per slot (0 pad)
    c_mask: jnp.ndarray  # (ne, nloc) 1.0 where the slot carries a multiplier
    f_loc: jnp.ndarray  # (ne, nloc) element-local velocity rhs
    g_loc: jnp.ndarray  # (ne,) element pressure rhs
    lam_src: jnp.ndarray  # (n_lam, 2) int32 flattened (e * nloc + slot) pairs
    lam_mask: jnp.ndarray  # (n_lam, 2)
    own_src: jnp.ndarray  # (n_u,) int32 owner (e * nloc + slot) per global face
    obs_u: jnp.ndarray  # (n_u,)
    obs_p: jnp.ndarray  # (n_s,)


def build_hybrid_level(lvl, ess: np.ndarray, rhs: np.ndarray, obs: np.ndarray,
                       dtype=jnp.float32) -> Optional[HybridLevel]:
    """Static hybridization tensors for one SimplicialLevel (None when the
    level carries no simplicial element geometry, e.g. agglomerated coarse
    levels - those fall back to the MINRES path)."""
    gm = getattr(lvl, "mesh", None)  # agglomerated levels carry no mesh
    if gm is None or not hasattr(gm, "elements"):
        return None
    try:
        Mt = element_outward_mass(gm)
    except (ValueError, AttributeError):
        return None
    ne, nloc, _ = Mt.shape
    n_u, n_s = lvl.n_u, lvl.n_s
    keep = ~ess[lvl.cell_faces]  # (ne, nloc) true dofs
    km = keep.astype(np.float64)
    Mm = Mt * km[:, :, None] * km[:, None, :]
    # Identity rows for the masked (essential) slots keep Mm invertible;
    # their A_unit rows/cols are zeroed below so u_ess = 0 exactly.
    idx = np.arange(nloc)
    Mm[:, idx, idx] += (1.0 - km)
    Minv = np.linalg.inv(Mm)
    b = km  # divergence row in the outward basis: 1 on true dofs
    Mb = np.einsum("eij,ej->ei", Minv, b)
    s_den = np.einsum("ei,ei->e", b, Mb)
    A_unit = Minv - Mb[:, :, None] * Mb[:, None, :] / s_den[:, None, None]
    A_unit = A_unit * km[:, :, None] * km[:, None, :]
    r_til = Mb / s_den[:, None]

    # Multiplier numbering: interior faces only (two adjacent elements).
    interior = lvl.face_signs[:, 1] != 0.0
    lam_of_face = np.full(n_u, -1, dtype=np.int64)
    lam_of_face[interior] = np.arange(int(interior.sum()))
    n_lam = int(interior.sum())
    c_idx = lam_of_face[lvl.cell_faces]
    c_mask = (c_idx >= 0).astype(np.float64)
    c_idx = np.maximum(c_idx, 0)

    # face -> (element, slot) pairs for the scatter-free gather-sum,
    # derived from the level's own face_cells incidence (owner first,
    # fem/simplicial.py:128-136) so the owner convention is defined in
    # exactly one place (review r3). slot = position of the face in the
    # adjacent cell's cell_faces row.
    faces = np.arange(n_u)
    e0 = lvl.face_cells[:, 0]
    slot0 = np.argmax(lvl.cell_faces[e0] == faces[:, None], axis=1)
    own_src = e0 * nloc + slot0
    fi = np.nonzero(interior)[0]
    e1 = lvl.face_cells[fi, 1]  # interior faces carry both neighbors
    slot1 = np.argmax(lvl.cell_faces[e1] == fi[:, None], axis=1)
    lam_src = np.stack([own_src[fi], e1 * nloc + slot1], axis=1)
    lam_mask = np.ones((n_lam, 2))

    # Element-local rhs: f_e = sign * rhs_u[face] (assumes rhs_u supported
    # on boundary faces - asserted), masked at essential slots.
    rhs_u = np.asarray(rhs[:n_u], dtype=np.float64)
    if np.any(rhs_u[interior] != 0.0):
        return None  # interior velocity loads would double-count; fall back
    f_loc = lvl.cell_signs * rhs_u[lvl.cell_faces] * km
    g_loc = np.asarray(rhs[n_u:], dtype=np.float64)

    j = jnp.asarray
    return HybridLevel(
        n_lam=n_lam,
        n_s=n_s,
        nloc=nloc,
        A_unit=j(A_unit, dtype=dtype),
        r_til=j(r_til, dtype=dtype),
        s_den=j(s_den, dtype=dtype),
        c_idx=j(c_idx, dtype=jnp.int32),
        c_mask=j(c_mask, dtype=dtype),
        f_loc=j(f_loc, dtype=dtype),
        g_loc=j(g_loc, dtype=dtype),
        lam_src=j(lam_src, dtype=jnp.int32),
        lam_mask=j(lam_mask, dtype=dtype),
        own_src=j(own_src, dtype=jnp.int32),
        obs_u=j(np.asarray(obs[:n_u]), dtype=dtype),
        obs_p=j(np.asarray(obs[n_u:]), dtype=dtype),
    )


def build_hybrid_level_algebraic(
    level, ess: np.ndarray, rhs: np.ndarray, obs: np.ndarray,
    dtype=jnp.float32,
) -> Optional[HybridLevel]:
    """Algebraic hybridization of a Galerkin face-form level - the
    agglomerated coarse levels whose MINRES saddle solves were the
    unstructured stack's bottleneck (round-5 measurement: the cold coarse
    member of a cube_tet refine-4 pair needed ~370 MINRES iterations vs
    ~70 for the hybridized fine level).

    Works because agglomerate_level assembles the coarse RT mass PER
    AGGLOMERATE (fem/agglomeration.py Mc_cell): M_c(w) = sum_a w_a A_a
    exactly, with A_a supported on agglomerate a's faces - the same
    element-block structure geometric hybridization exploits, recursively
    true for agglomerates of agglomerates. Differences from the geometric
    builder (build_hybrid_level): the local blocks come from the level's
    mass triplets instead of simplex quadrature; everything stays in the
    GLOBAL orientation basis, so the divergence row is b_e = cell_signs
    (not all-ones) and the flux-continuity constraint u_owner - u_second
    = 0 carries the +-1 orientation through c_mask / lam_mask (the
    condensation algebra in hybrid_solve is basis-agnostic; derivation in
    its docstring applies verbatim with general b_e). Reference analog:
    the element-matrix rescaling hybridization the reference applies on
    ANY ParELAG level, /root/reference/src/DarcySolver.cpp:586-626.

    Returns None (MINRES fallback) if the per-cell blocks do not tile the
    mass, a kept block is not SPD, or interior velocity loads exist."""
    from parelagmc_tpu.fem.agglomeration import _level_mass_triplets

    cf = np.asarray(level.cell_faces, dtype=np.int64)
    cs = np.asarray(level.cell_signs, dtype=np.float64)
    n_u, n_s = level.n_u, level.n_s
    ne, nloc = cf.shape
    try:
        mr, mc, mv, mcell = _level_mass_triplets(level)
    except (AttributeError, ValueError):
        return None
    rows_cf = cf[mcell]
    si = np.argmax(rows_cf == mr[:, None], axis=1)
    sj = np.argmax(rows_cf == mc[:, None], axis=1)
    nz = mv != 0.0
    ok = (
        (cf[mcell, si] == mr) & (cf[mcell, sj] == mc)
        & (cs[mcell, si] != 0.0) & (cs[mcell, sj] != 0.0)
    )
    if not ok[nz].all():
        return None  # a mass entry outside its cell's face list
    Mt = np.zeros((ne, nloc, nloc))
    np.add.at(Mt, (mcell[nz], si[nz], sj[nz]), mv[nz])

    km = ((cs != 0.0) & ~ess[cf]).astype(np.float64)
    Mm = Mt * km[:, :, None] * km[:, None, :]
    idx = np.arange(nloc)
    Mm[:, idx, idx] += 1.0 - km
    try:
        if np.linalg.eigvalsh(Mm).min() <= 0.0:
            return None  # kept block not SPD: condensation invalid
        Minv = np.linalg.inv(Mm)
    except np.linalg.LinAlgError:
        return None
    b = cs * km
    Mb = np.einsum("eij,ej->ei", Minv, b)
    s_den = np.einsum("ei,ei->e", b, Mb)
    if np.any(s_den <= 0.0):
        return None
    A_unit = (
        Minv - Mb[:, :, None] * Mb[:, None, :] / s_den[:, None, None]
    ) * km[:, :, None] * km[:, None, :]
    r_til = Mb / s_den[:, None]

    interior = level.face_signs[:, 1] != 0.0
    lam_of_face = np.full(n_u, -1, dtype=np.int64)
    lam_of_face[interior] = np.arange(int(interior.sum()))
    n_lam = int(interior.sum())
    if n_lam == 0:
        # A single agglomerate has no interior faces - no multiplier
        # system to condense to; the MINRES path handles the tiny level.
        return None
    c_idx = lam_of_face[cf]
    present = (c_idx >= 0) & (km > 0.0)
    # Signed continuity: owner copy +1, second copy -1 (global basis);
    # cell_signs is exactly that orientation.
    c_mask = np.where(present, cs, 0.0)
    c_idx = np.maximum(c_idx, 0)

    faces = np.arange(n_u)
    e0 = level.face_cells[:, 0]
    slot0 = np.argmax(cf[e0] == faces[:, None], axis=1)
    own_src = e0 * nloc + slot0
    fi = np.nonzero(interior)[0]
    e1 = level.face_cells[fi, 1]
    slot1 = np.argmax(cf[e1] == fi[:, None], axis=1)
    lam_src = np.stack([own_src[fi], e1 * nloc + slot1], axis=1)
    lam_mask = np.stack([cs[e0[fi], slot0[fi]], cs[e1, slot1]], axis=1)

    rhs_u = np.asarray(rhs[:n_u], dtype=np.float64)
    if np.any(rhs_u[interior] != 0.0):
        return None  # interior velocity loads would double-count
    # Global basis: local rhs is the face value itself (the geometric
    # builder's cell_signs factor converts to its outward basis).
    f_loc = rhs_u[cf] * km
    g_loc = np.asarray(rhs[n_u:], dtype=np.float64)

    j = jnp.asarray
    return HybridLevel(
        n_lam=n_lam,
        n_s=n_s,
        nloc=nloc,
        A_unit=j(A_unit, dtype=dtype),
        r_til=j(r_til, dtype=dtype),
        s_den=j(s_den, dtype=dtype),
        c_idx=j(c_idx, dtype=jnp.int32),
        c_mask=j(c_mask, dtype=dtype),
        f_loc=j(f_loc, dtype=dtype),
        g_loc=j(g_loc, dtype=dtype),
        lam_src=j(lam_src, dtype=jnp.int32),
        lam_mask=j(lam_mask, dtype=dtype),
        own_src=j(own_src, dtype=jnp.int32),
        obs_u=j(np.asarray(obs[:n_u]), dtype=dtype),
        obs_p=j(np.asarray(obs[n_u:]), dtype=dtype),
    )


def _face_sum(H: HybridLevel, ue: jnp.ndarray) -> jnp.ndarray:
    """(batch, ne, nloc) element-slot values -> (batch, n_lam) sums over
    the (<= 2) slots of each multiplier face."""
    flat = ue.reshape(ue.shape[:-2] + (-1,))
    g = jnp.take(flat, H.lam_src.reshape(-1), axis=-1).reshape(
        flat.shape[:-1] + H.lam_src.shape
    )
    return jnp.sum(g * H.lam_mask, axis=-1)


def hybrid_solve(
    H: HybridLevel,
    w: jnp.ndarray,
    max_iters: int,
    rtol: float,
    atol: float = 0.0,
    restart_every: int = 0,
    aux_cycle=None,
    lam0=None,
    return_lam: bool = False,
):
    """Solve the hybridized system for a batch of coefficients w
    (batch, n_s). Returns (Q, info, p_elem) with p_elem the recovered
    element pressures (batch, n_cells).

    aux_cycle: optional cell-space SPD V-cycle r_cell -> z_cell
    (approximating S(w)^{-1} = (B M(w)^{-1} B^T)^{-1}, e.g. the per-sample
    graph coef-MG). Used as the coarse half of an auxiliary-space
    preconditioner: multipliers are pressure traces, so the average-of-
    adjacent-cells interpolation Pi transfers the residual to cells, the
    V-cycle kills the smooth/global modes Jacobi cannot (the structure of
    hypre's auxiliary-space AMG the reference leans on), and Jacobi
    handles the face-local modes. Measured on cylinder.mesh (1 refinement,
    rtol 1e-6): 187 Jacobi-only -> ~30 iterations."""
    winv = 1.0 / w  # (batch, ne)

    def local_apply(vals):
        # precision=highest: at DEFAULT precision an accelerator may round
        # float32 einsum inputs (bfloat16 passes, TF32 on the GPU), and
        # the resulting operator noise puts an apparent Krylov floor near
        # 1e-4: rtol 1e-5 pairs that converge on CPU f32 stall. The blocks
        # are (nloc x nloc) smalls; the full-precision cost is noise next
        # to the gathers.
        ue = jnp.einsum(
            "eij,...ej->...ei", H.A_unit, vals, precision="highest"
        )
        return ue * winv[..., None]

    def gather_lam(lam):
        le = jnp.take(lam, H.c_idx.reshape(-1), axis=-1).reshape(
            lam.shape[:-1] + H.c_idx.shape
        )
        return le * H.c_mask

    apply_H = lambda lam: _face_sum(H, local_apply(gather_lam(lam)))

    # rhs_H = sum_e C_e [ (1/w) A f + r g ].
    fl = jnp.broadcast_to(H.f_loc, w.shape[:-1] + H.f_loc.shape)
    rhs = _face_sum(
        H, local_apply(fl) + H.r_til * H.g_loc[..., None]
    )

    # Jacobi: diag H = sum over the slots of each face of (1/w_e) A[slot,slot].
    # PRESENCE masks (mask^2), not the signed masks: the algebraic builder
    # carries the +-1 continuity orientation in lam_mask/c_mask, and
    # diag H_ff = sum C^2 A[slot,slot]/w is orientation-free (a signed sum
    # here made the Jacobi diagonal ~0/negative and broke CG on the
    # agglomerated levels; geometric levels have 0/1 masks, unchanged).
    lam_abs = H.lam_mask * H.lam_mask
    c_abs = H.c_mask * H.c_mask
    a_dd = jnp.diagonal(H.A_unit, axis1=-2, axis2=-1)  # (ne, nloc)
    dflat = (a_dd * winv[..., None]).reshape(w.shape[:-1] + (-1,))
    dg = jnp.take(dflat, H.lam_src.reshape(-1), axis=-1).reshape(
        dflat.shape[:-1] + H.lam_src.shape
    )
    diag = jnp.maximum(jnp.sum(dg * lam_abs, axis=-1), 1e-30)
    # Constant-mode deflation: every element block annihilates local
    # constants (A^unit b = 0), so H is nearly singular on the constant
    # multiplier vector (anchored only through boundary elements) - the
    # classic near-null mode of a Neumann-dominated trace system. A
    # rank-one SPD augmentation of the Jacobi preconditioner removes that
    # smallest eigenvalue at the cost of one extra operator application
    # per SOLVE (not per iteration); measured 45 -> ~25 iterations on
    # cube_tet at rtol 1e-8.
    v = jnp.ones(rhs.shape, dtype=rhs.dtype) / np.sqrt(max(H.n_lam, 1))
    Hv = apply_H(v)
    vHv = jnp.maximum(jnp.sum(v * Hv, axis=-1, keepdims=True), 1e-30)

    if aux_cycle is not None:
        lam_elems = H.lam_src // H.nloc  # (n_lam, 2) adjacent elements

        def pi_apply(r_cell):  # cells -> multipliers (average of the two)
            # lambda is the interface PRESSURE trace - orientation-free -
            # so the interpolation uses presence masks (see diag note).
            g = jnp.take(r_cell, lam_elems.reshape(-1), axis=-1).reshape(
                r_cell.shape[:-1] + lam_elems.shape
            )
            return 0.5 * jnp.sum(g * lam_abs, axis=-1)

        def pi_t_apply(r_lam):  # multipliers -> cells
            g = jnp.take(r_lam, H.c_idx.reshape(-1), axis=-1).reshape(
                r_lam.shape[:-1] + H.c_idx.shape
            )
            return 0.5 * jnp.sum(g * c_abs, axis=-1)

        def prec(r):
            return (
                r / diag
                + pi_apply(aux_cycle(pi_t_apply(r)))
                + v * (jnp.sum(v * r, axis=-1, keepdims=True) / vHv)
            )

    else:

        def prec(r):
            return r / diag + v * (
                jnp.sum(v * r, axis=-1, keepdims=True) / vHv
            )

    lam, info = pcg(
        apply_H,
        rhs,
        prec=prec,
        x0=lam0,
        max_iters=max_iters,
        rtol=rtol,
        atol=atol,
        restart_every=restart_every,
    )

    # Element-local recovery.
    resid = fl - gather_lam(lam)
    ue = local_apply(resid) + H.r_til * H.g_loc[..., None]
    pe = jnp.sum(H.r_til * resid, axis=-1) - w * H.g_loc / H.s_den
    u_flat = ue.reshape(ue.shape[:-2] + (-1,))
    u_glob = jnp.take(u_flat, H.own_src, axis=-1)
    Q = jnp.sum(u_glob * H.obs_u, axis=-1) + jnp.sum(pe * H.obs_p, axis=-1)
    if return_lam:
        # Multiplier returned for mean-field warm starts (lam0 above):
        # the trace system's solution, cached once per level by the
        # unstructured solver (cf. physics/darcy.py _meanfield_start).
        return Q, info, pe, lam
    return Q, info, pe
