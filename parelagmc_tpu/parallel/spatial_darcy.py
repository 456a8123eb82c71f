"""Spatially-sharded Darcy Schur solves: one realization split over a
device mesh.

The reference's model-parallel axis partitions the mesh across MPI ranks
and runs every matvec/solve as a collective with halo exchange
(/root/reference/src/DarcySolver.cpp:651-675 SolveFwd on ParMesh +
SharingMap Assemble/Distribute). Round 2 shipped a generic-CSR prototype
(parallel/spatial.py); this module integrates the axis with the REAL
structured Darcy operators (VERDICT r2 item 3), so the SPE10 finest level
(4.5M dofs, and 8x that refined once) can spread one realization's
solve state over the 'sp' axis of a device mesh.

Design (tensor-native, no translated SharingMaps):

* The domain is cut into equal slabs along the mesh y axis (under the
  axis_order="auto" layout, relabel the grid so the axis to cut lands on
  y before constructing the solver). Cell fields, x/z face grids and the
  slab-owned y-face planes live shard-local; every operator application
  is grid arithmetic on the local block plus a one-plane `ppermute` halo
  exchange.
* The exact batched M(w)^{-1} survives sharding: lines orthogonal to the
  cut axis stay shard-local (plain Thomas); lines ALONG the cut axis are
  solved exactly by a SPIKE reduction - factored once per Krylov solve
  (local spike solves, an `all_gather` of four tip scalars per line, LU
  of the 2*n_sp interface system - 16x16 for 8 shards), then applied per
  iteration with one local Thomas plus an `all_gather` of TWO scalars
  per line, instead of a sequential scan across devices.
* The pressure Schur CG runs entirely inside one `shard_map` program:
  dot products are `psum` (the MPI_Allreduce analog), the solution,
  residuals and Krylov directions never materialize unsharded.
* Sample and spatial parallelism compose: with n_dp > 1 the device mesh
  is 2D (dp, sp) - the batch shards over 'dp' while each realization's
  grid shards over 'sp' (the while_loop continue-flag is psum-reduced
  over dp so converged rows cannot exit the collective loop early).
* With the cg-schur-coefmg solver the preconditioner is a two-level
  Schwarz per-sample Galerkin MG: slab-local V-cycles (restricted
  additive Schwarz blocks with true halo-coupled cut-face diagonals)
  plus a replicated global coarse correction grafted at the deepest
  pair-aligned slab level (one small all_gather per iteration). Measured
  at synthetic-SPE10 contrast on (60,110,42)/8 shards
  (examples/spatial_scaling.py): 50 iterations vs
  45 replicated coefMG at rtol 1e-5 with the SAME deep-truth QoI error
  (2.6e-2 vs 3.0e-2 - both are loose-rtol Krylov error; rtol 1e-7 costs
  90 iterations and lands at 4.4e-4), where slab-Jacobi needs 277
  iterations and 77% QoI error at the same residual.
* Warm starts (p0 = prolongated coarse pressure of an MLMC pair) and
  physical-pressure return make the sharded solve a drop-in for the
  manager's cold/warm/segmented steps: DarcySolver routes its finest
  level here when config.darcy_solver.spatial_shards > 1, so an MLMC
  run picks up spatial DD from the config surface alone
  (tests/test_spatial_darcy.py::test_mlmc_with_spatial_sharding).

Validated against the unsharded DarcySolver on the virtual 8-device CPU
mesh at SPE10-shaped sizes (tests/test_spatial_darcy.py). Measured
footprint (XLA compiled memory_analysis, (60,110,42) grid, coefmg,
batch 8, f32): per-device temp 530.5 MB unsharded -> 103.0 MB on 8
shards (5.2x; the remainder is the replicated global coarse correction
plus halo padding).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def spike_tridiag_factor(dl, d, du, axis_name: str, n_sp: int):
    """Matrix-dependent half of the shard-distributed SPIKE tridiagonal
    solve: decoupled local tables, the two boundary spikes, and the
    LU-factored 2*n_sp interface system. The tables depend only on the
    sample coefficient, so callers factor ONCE per Krylov solve and apply
    per iteration (XLA does not hoist this out of while_loop bodies;
    review r3).

    Each shard holds m consecutive rows of every line. dl[..., 0] is the
    coupling to the previous shard's last row (0 on shard 0), du[..., -1]
    the coupling to the next shard's first row (0 on the last shard) -
    i.e. callers pass the GLOBAL line coefficients sliced per shard.
    """
    from jax.scipy.linalg import lu_factor

    from parelagmc_tpu.ops.tridiag import solve_lines

    # Decouple the chunk: interior tridiag drops the cross-shard couplings.
    dl_in = dl.at[..., 0].set(0.0)
    du_in = du.at[..., -1].set(0.0)
    # Boundary spikes: local solves against the cross-shard couplings.
    e_lo = jnp.zeros_like(d).at[..., 0].set(1.0) * dl[..., :1]
    e_hi = jnp.zeros_like(d).at[..., -1].set(1.0) * du[..., -1:]
    sol = solve_lines(dl_in[None], d[None], du_in[None],
                        jnp.stack([e_lo, e_hi], axis=0))
    v, w = sol[0], sol[1]

    # Interface matrix in u = [a_0, z_0, a_1, z_1, ...] (a_s/z_s = first/
    # last entry of shard s's true solution):
    #   a_s + v_s[0]  * z_{s-1} + w_s[0]  * a_{s+1} = xd_s[0]
    #   z_s + v_s[-1] * z_{s-1} + w_s[-1] * a_{s+1} = xd_s[-1]
    tips = jnp.stack(
        [v[..., 0], v[..., -1], w[..., 0], w[..., -1]], axis=-1
    )  # (..., 4)
    allt = jax.lax.all_gather(tips, axis_name)  # (n_sp, ..., 4)
    ns2 = 2 * n_sp
    batch = tips.shape[:-1]
    A = jnp.zeros(batch + (ns2, ns2), dtype=d.dtype) + jnp.eye(
        ns2, dtype=d.dtype
    )
    for s in range(n_sp):
        d0 = jnp.moveaxis(allt[s], -1, 0)  # (4, ...)
        if s > 0:
            A = A.at[..., 2 * s, 2 * s - 1].set(d0[0])
            A = A.at[..., 2 * s + 1, 2 * s - 1].set(d0[1])
        if s + 1 < n_sp:
            A = A.at[..., 2 * s, 2 * (s + 1)].set(d0[2])
            A = A.at[..., 2 * s + 1, 2 * (s + 1)].set(d0[3])
    return dl_in, d, du_in, v, w, lu_factor(A)


def spike_tridiag_apply(factors, b, axis_name: str, n_sp: int):
    """rhs-dependent half: local Thomas on the decoupled chunk, all_gather
    of TWO scalars per line, LU back-substitution of the interface system
    (redundant per shard), spike combination."""
    from jax.scipy.linalg import lu_solve

    from parelagmc_tpu.ops.tridiag import solve_lines

    dl_in, d, du_in, v, w, lu = factors
    xd = solve_lines(dl_in, d, du_in, b)
    tips = jnp.stack([xd[..., 0], xd[..., -1]], axis=-1)  # (..., 2)
    allt = jax.lax.all_gather(tips, axis_name)  # (n_sp, ..., 2)
    ns2 = 2 * n_sp
    rhs_r = jnp.moveaxis(allt, 0, -2).reshape(tips.shape[:-1] + (ns2,))
    u = lu_solve(lu, rhs_r[..., None])[..., 0]

    s_idx = jax.lax.axis_index(axis_name)
    z_prev = jnp.where(
        s_idx > 0,
        jnp.take(u, jnp.maximum(2 * s_idx - 1, 0), axis=-1),
        0.0,
    )
    a_next = jnp.where(
        s_idx + 1 < n_sp,
        jnp.take(u, jnp.minimum(2 * (s_idx + 1), ns2 - 1), axis=-1),
        0.0,
    )
    return xd - v * z_prev[..., None] - w * a_next[..., None]


def spike_tridiag_solve(dl, d, du, b, axis_name: str, n_sp: int):
    """Exact solve of shard-distributed tridiagonal systems along the LAST
    axis (batched over leading dims), inside shard_map: one-shot
    factor + apply (Krylov callers keep the factors instead)."""
    return spike_tridiag_apply(
        spike_tridiag_factor(dl, d, du, axis_name, n_sp), b, axis_name, n_sp
    )


def _parse_line_axes_compat(scfg, mesh) -> tuple:
    """config.coefmg_line_axes for the spatial path: explicit letters only
    ("auto" needs the reference coefficient, unavailable here -> ())."""
    spec = (getattr(scfg, "coefmg_line_axes", "") or "").strip().lower()
    if spec == "auto":
        # Surface the fallback instead of quietly dropping the smoother a
        # user validated on the replicated path (review r3; mirrors the
        # split_pair_programs fallback warning).
        import warnings

        warnings.warn(
            "coefmg_line_axes='auto' is unavailable on the spatially-"
            "sharded path (auto selection needs the reference coefficient);"
            " running WITHOUT line relaxation. Pass explicit letters (e.g."
            " 'xz') to keep line smoothing under spatial_shards.",
            stacklevel=2,
        )
        return ()
    if not spec:
        return ()
    from parelagmc_tpu.physics.darcy import _parse_line_axes

    return _parse_line_axes(spec, mesh, None)


class _Grids(NamedTuple):
    """Global grid-form static data, every array sharded along its y dim
    inside the shard_map (cells: (nz, ny, nx); a-faces: +1 plane along a).
    The y-face grids carry planes 0..ny-1; plane ny must be essential
    (asserted at build), so no shard ever needs its value."""

    # Per-axis tridiagonal mass tables on the CELL grid (kinv baked; the
    # same (bll, blr, brr) blocks that drive the unsharded solver).
    bll: Tuple[jnp.ndarray, ...]  # per mesh axis (x, y, z)
    blr: Tuple[jnp.ndarray, ...]
    brr: Tuple[jnp.ndarray, ...]
    ess: Tuple[jnp.ndarray, ...]  # per-axis face-grid essential masks (bool)
    rhs_u: Tuple[jnp.ndarray, ...]  # per-axis face-grid velocity rhs
    obs_u: Tuple[jnp.ndarray, ...]
    rhs_p: jnp.ndarray  # cell grid
    obs_p: jnp.ndarray
    pad_cell: jnp.ndarray  # bool cell grid: padded (non-physical) cells
    sdiag: jnp.ndarray  # cell grid: diag of S_bar (Jacobi preconditioner)




class SpatialDarcy:
    """One Darcy level's pressure Schur-complement CG, spatially sharded
    along the mesh y axis over a device mesh ('sp').

    Built from the SAME per-(cell, axis) mass blocks as the unsharded
    DarcySolver level (use .from_darcy), so the sharded solve is the
    identical discrete problem - validated to agree with
    DarcySolver.solve_fwd to solver tolerance (tests/test_spatial_darcy.py).

    Restrictions (asserted): the cut-axis boundary faces must be essential
    on both ends (true for the SPDE sampler - all sides essential - and for
    the reference's default/SPE10 Darcy BCs, where flow is along z/x), and
    ny is padded up to a multiple of the shard count with decoupled
    identity cells.
    """

    def __init__(
        self,
        mesh,
        blocks,
        ess_attr: np.ndarray,
        rhs: np.ndarray,
        obs: np.ndarray,
        sbar_diag: np.ndarray,
        n_sp: Optional[int] = None,
        devices: Optional[List] = None,
        dtype=jnp.float32,
        max_iters: int = 300,
        rtol: float = 1e-6,
        axis: str = "sp",
        ess: Optional[np.ndarray] = None,
        n_dp: int = 1,
        sample_axis: str = "dp",
        precond: str = "jacobi",
        mg_opts: Optional[dict] = None,
        restart_every: int = 50,
    ):
        if devices is None:
            devices = jax.devices()
        if n_sp is None:
            n_sp = len(devices) // max(1, n_dp)
        self.n_dp = int(n_dp)
        self.sample_axis = sample_axis
        self.restart_every = int(restart_every)
        if n_dp * n_sp > len(devices):
            raise ValueError(
                f"spatial mesh needs n_dp * n_sp = {n_dp} * {n_sp} = "
                f"{n_dp * n_sp} devices, only {len(devices)} available"
            )
        if self.n_dp > 1:
            # Composed sample x spatial parallelism: the device mesh is
            # (dp, sp); the sample batch shards over dp while each
            # realization's grid shards over sp (the analog of
            # "several MPI jobs, each domain-decomposed").
            dev = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
            self.mesh_dev = Mesh(dev, (sample_axis, axis))
        else:
            self.mesh_dev = Mesh(np.asarray(devices[:n_sp]), (axis,))
        self.n_sp = n_sp
        self.axis = axis
        self.dtype = dtype
        self.max_iters = int(max_iters)
        self.rtol = float(rtol)
        d = mesh.dim
        if d != 3:
            raise ValueError("SpatialDarcy implements the 3D grid layout")
        nx, ny, nz = mesh.shape
        self.shape = (nx, ny, nz)
        from parelagmc_tpu.mesh.structured import _mfem_bdr_attr

        ess_attr = np.asarray(ess_attr, dtype=np.int64)
        for side in (0, 1):
            if ess_attr[_mfem_bdr_attr(3, 1, side) - 1] != 1:
                raise ValueError(
                    "spatial sharding cuts the y axis: both y boundaries "
                    "must be essential (u.n = 0) so no shard needs the "
                    "closing face plane"
                )
        self.pad = (-ny) % n_sp
        self.ny_pad = ny + self.pad
        self.m = self.ny_pad // n_sp
        self.precond = precond
        if precond == "coefmg":
            # Slab-local per-sample Galerkin MG (restricted additive
            # Schwarz): every shard runs the SAME static V-cycle ladder on
            # its (nx, m, nz) slab; the cut faces keep their true
            # halo-coupled mass diagonal, so each block is the exact
            # diagonal-of-S slab block with Dirichlet-0 ghost data
            # (nonsingular). Iteration counts stay near the replicated
            # coefMG path where slab-Jacobi degrades with the grid
            # (measured (32,64,16) synthetic-SPE10: 250 Jacobi vs 48
            # replicated-MG iterations, and Jacobi's equal-residual QoI
            # error blows up at scale - the rtol trap of CLAUDE.md).
            from parelagmc_tpu.mesh.factories import make_box_mesh
            from parelagmc_tpu.ops.coef_multigrid_structured import (
                build_struct_coef_mg,
            )

            o = dict(mg_opts or {})
            self.mg_cycles = max(1, int(o.pop("cycles", 1)))
            self.mg_sweeps = max(1, int(o.pop("sweeps", 2)))
            self.mg_prec_dtype = o.pop("prec_dtype", "") or None
            two_level = bool(o.pop("two_level", True))
            # The slab ladder's coarsening cutoff scales with 1/n_sp: the
            # AGGREGATE coarsest size across shards then matches the
            # replicated ladder's cutoff, and small slabs still coarsen
            # (a 4096-cell slab under the replicated 5000 cutoff would
            # get a single-level ladder = bare Jacobi sweeps).
            o_slab = dict(o)
            o_slab["cutoff"] = max(256, int(o.get("cutoff", 5000)) // n_sp)
            self.slab_mg = build_struct_coef_mg(
                make_box_mesh((nx, self.m, nz)), **o_slab
            )
            # Two-level Schwarz: a replicated global coarse correction on
            # top of the slab blocks restores the cross-slab smooth modes
            # the slab-local ladder cannot see. Handoff at the deepest
            # slab level whose y-coarsening stays pair-aligned within
            # every slab (all slab y sizes even down to it) - there the
            # union of the slabs' coarse grids IS the full grid's coarse
            # level, so the gathered slab dinv axes feed a global ladder
            # that keeps coarsening without alignment constraints.
            self.k_handoff = 0
            lv = self.slab_mg.levels
            for k in range(1, len(lv)):
                if lv[k - 1].shape[1] % 2 or lv[k].shape[1] * 2 != lv[
                    k - 1
                ].shape[1]:
                    break
                self.k_handoff = k
            self.global_mg = None
            if two_level and self.k_handoff > 0:
                kh = self.k_handoff
                gx, gy, gz = lv[kh].shape
                self.global_mg = build_struct_coef_mg(
                    make_box_mesh((gx, n_sp * gy, gz)), **o
                )
        elif precond != "jacobi":
            raise ValueError(f"unknown precond {precond!r}")
        self.n_u = mesh.num_faces
        self.n_s = mesh.num_cells
        self._face_offsets = tuple(int(x) for x in mesh.face_offsets)

        bll, blr, brr = blocks

        def cell_grid(v):
            g = np.asarray(v, dtype=np.float64).reshape(nz, ny, nx)
            return np.pad(g, ((0, 0), (0, self.pad), (0, 0)))

        # Padded cells: identity x/z rows (bll = brr = 1/2 with w = 1),
        # fully decoupled along y (tables 0 there; the padded y-face rows
        # are masked essential below).
        pad_cell = np.zeros((nz, self.ny_pad, nx), dtype=bool)
        pad_cell[:, ny:, :] = True
        g_bll, g_blr, g_brr = [], [], []
        for a in range(3):
            lo = cell_grid(bll[:, a])
            mid = cell_grid(blr[:, a])
            hi = cell_grid(brr[:, a])
            if a != 1:
                lo[pad_cell] = 0.5
                hi[pad_cell] = 0.5
            g_bll.append(lo)
            g_blr.append(mid)
            g_brr.append(hi)

        # Essential face masks as face grids; y grid keeps planes 0..ny-1
        # and marks every padded plane essential.
        lvl_ess = self._ess_face_grids(mesh, ess_attr, ess)
        ess_x, ess_y, ess_z = lvl_ess
        ess_y = np.pad(
            np.asarray(ess_y), ((0, 0), (0, self.pad), (0, 0)),
            constant_values=True,
        )
        ess_x = np.pad(
            np.asarray(ess_x), ((0, 0), (0, self.pad), (0, 0)),
            constant_values=True,
        )
        ess_z = np.pad(
            np.asarray(ess_z), ((0, 0), (0, self.pad), (0, 0)),
            constant_values=True,
        )

        def split_rhs(v):
            v = np.asarray(v, dtype=np.float64)
            fo = self._face_offsets
            vx = v[fo[0]: fo[1]].reshape(nz, ny, nx + 1)
            vy = v[fo[1]: fo[2]].reshape(nz, ny + 1, nx)
            vz = v[fo[2]: fo[3]].reshape(nz + 1, ny, nx)
            # Drop the closing y plane (essential, value irrelevant) and
            # pad the y dims.
            vx = np.pad(vx, ((0, 0), (0, self.pad), (0, 0)))
            vy = np.pad(vy[:, :ny, :], ((0, 0), (0, self.pad), (0, 0)))
            vz = np.pad(vz, ((0, 0), (0, self.pad), (0, 0)))
            vp = np.pad(
                v[self.n_u:].reshape(nz, ny, nx),
                ((0, 0), (0, self.pad), (0, 0)),
            )
            return (vx, vy, vz), vp

        (rux, ruy, ruz), rp = split_rhs(rhs)
        (oux, ouy, ouz), op_ = split_rhs(obs)
        # Essential-face rhs entries must be zero (DarcySolver zeroes them
        # at setup; direct construction with a raw assembled rhs would
        # otherwise leak the boundary values through the identity rows of
        # the tridiagonal solves - review r3).
        rux[np.asarray(ess_x)] = 0.0
        ruy[np.asarray(ess_y)] = 0.0
        ruz[np.asarray(ess_z)] = 0.0
        sd = cell_grid(sbar_diag)
        sd[pad_cell] = 1.0

        j = jnp.asarray
        self.grids = _Grids(
            bll=tuple(j(g, dtype=dtype) for g in g_bll),
            blr=tuple(j(g, dtype=dtype) for g in g_blr),
            brr=tuple(j(g, dtype=dtype) for g in g_brr),
            ess=(j(ess_x), j(ess_y), j(ess_z)),
            rhs_u=(j(rux, dtype=dtype), j(ruy, dtype=dtype), j(ruz, dtype=dtype)),
            obs_u=(j(oux, dtype=dtype), j(ouy, dtype=dtype), j(ouz, dtype=dtype)),
            rhs_p=j(rp, dtype=dtype),
            obs_p=j(op_, dtype=dtype),
            pad_cell=j(pad_cell),
            sdiag=j(sd, dtype=dtype),
        )
        self._jit_solve = {}

    @staticmethod
    def _ess_face_grids(mesh, ess_attr, ess=None):
        """Essential-face masks reshaped to per-axis grids. Pass the flat
        `ess` mask when the caller already holds it (from_darcy does:
        DarcyLevel.ess) - rebuilding the full MixedLevel at SPE10 scale
        (3.4M faces) just for this mask costs seconds of host assembly
        (review r3)."""
        nx, ny, nz = mesh.shape
        if ess is None:
            from parelagmc_tpu.fem.assembly import build_mixed_level

            ess = build_mixed_level(mesh).ess_faces(ess_attr)
        ess = np.asarray(ess)
        fo = mesh.face_offsets
        return (
            ess[fo[0]: fo[1]].reshape(nz, ny, nx + 1),
            ess[fo[1]: fo[2]].reshape(nz, ny + 1, nx)[:, :ny, :],
            ess[fo[2]: fo[3]].reshape(nz + 1, ny, nx),
        )

    @classmethod
    def from_darcy(cls, solver, level: int, **kw):
        """Build from a DarcySolver level: same mass blocks, BCs, rhs and
        QoI functional, so the sharded solve is the identical discrete
        problem (the integration the round-2 prototype lacked)."""
        mesh = solver.hierarchy.levels[level].mesh
        blocks = solver.level_blocks(level)
        L = solver.levels[level]
        sdiag = solver.sbar_diag_np(level)
        scfg = solver.solver_cfg
        kw.setdefault(
            "precond",
            "coefmg" if scfg.name == "cg-schur-coefmg" else "jacobi",
        )
        kw.setdefault(
            "mg_opts",
            {
                "cutoff": scfg.coarse_dense_cutoff,
                "coarse_sweeps": max(1, scfg.mg_coarse_sweeps),
                "omega": getattr(scfg, "coefmg_omega", 0.8),
                "cheby_order": getattr(scfg, "coefmg_cheby_order", 0),
                "cheby_lo": getattr(scfg, "coefmg_cheby_lo", 0.25),
                "cycles": max(1, getattr(scfg, "coefmg_cycles", 1)),
                "sweeps": max(1, getattr(scfg, "coefmg_sweeps", 2)),
                "prec_dtype": getattr(scfg, "coefmg_prec_dtype", ""),
                # Barrier-aware knobs pass straight through to
                # build_struct_coef_mg. Line relaxation along the sharded
                # y axis becomes SLAB-LOCAL lines (a Schwarz-style block
                # smoother, not a global y-line solve) - still convergent,
                # just weaker across slab cuts. "auto" resolves to () here
                # (no kinv at this call site); spell axes explicitly.
                "line_axes": _parse_line_axes_compat(scfg, mesh),
                "line_omega": getattr(scfg, "coefmg_line_omega", 1.0),
                "coarsen": getattr(scfg, "coefmg_coarsen", "galerkin"),
            },
        )
        return cls(
            mesh,
            blocks,
            np.asarray(solver.config.ess_attr[:6]),
            np.asarray(L.rhs, dtype=np.float64),
            np.asarray(L.obs_func, dtype=np.float64),
            sdiag,
            dtype=solver.dtype,
            max_iters=solver.solver_cfg.max_iterations,
            rtol=solver.solver_cfg.relative_tolerance,
            ess=np.asarray(L.ess),
            restart_every=int(
                getattr(scfg, "restart_every", 50) or 0
            ),
            **kw,
        )

    # -- sharded apply pieces (all called INSIDE shard_map) -------------------
    def _halo_up(self, x_last_plane):
        """Send each shard's LAST y-plane to the shard above; shard 0
        receives zeros."""
        return jax.lax.ppermute(
            x_last_plane, self.axis,
            [(i, i + 1) for i in range(self.n_sp - 1)],
        )

    def _halo_dn(self, x_first_plane):
        """Send each shard's FIRST y-plane to the shard below; the last
        shard receives zeros."""
        return jax.lax.ppermute(
            x_first_plane, self.axis,
            [(i, i - 1) for i in range(1, self.n_sp)],
        )

    def _minv_factor(self, g, w, w_dn, blo_y, bmid_y):
        """Tridiagonal tables + SPIKE factorization for M(w)^{-1}. Depends
        only on the sample coefficient: factor ONCE per solve (before the
        CG while_loop - XLA does not hoist this out of loop bodies; review
        r3) and apply per iteration via _minv_apply. w_dn: halo of the
        below-shard's last cell plane of w; blo_y/bmid_y: halos of its
        brr_y/blr_y tables."""
        from parelagmc_tpu.ops.mass_solve import build_line_tables

        # x lines: local, along the last axis directly.
        fx = build_line_tables(g.bll[0], g.blr[0], g.brr[0], g.ess[0], w)
        # z lines: move z (dim -3) last.
        mv = lambda t: jnp.moveaxis(t, -3, -1)
        fz = build_line_tables(
            mv(g.bll[2]), mv(g.blr[2]), mv(g.brr[2]), mv(g.ess[2]), mv(w)
        )
        # y lines: rows = the m local planes; face j couples the below cell
        # (halo w_dn/blo_y/bmid_y for j = 0) and the local cell j.
        my = lambda t: jnp.moveaxis(t, -2, -1)  # (..., m | faces, x)->(..., x, m)
        w_t = my(w)
        w_lo = jnp.concatenate([my(w_dn), w_t[..., :-1]], axis=-1)
        brr_lo = jnp.concatenate([my(blo_y), my(g.brr[1])[..., :-1]], axis=-1)
        blr_lo = jnp.concatenate([my(bmid_y), my(g.blr[1])[..., :-1]], axis=-1)
        diag = w_lo * brr_lo + w_t * my(g.bll[1])
        dl = w_lo * blr_lo
        du = w_t * my(g.blr[1])
        essy = my(g.ess[1])
        # Essential-row masking incl. couplings into essential neighbors.
        # The global closing plane (p = ny) is essential by construction,
        # so the last active row's du is zeroed by ess_next of the padded
        # plane when pad > 0, and must be zeroed explicitly on the last
        # shard's last row when pad == 0.
        ess_prev = jnp.concatenate([essy[..., :1] * False, essy[..., :-1]], axis=-1)
        s_idx = jax.lax.axis_index(self.axis)
        first_global = (s_idx == 0)
        # Row 0's previous row lives on the BELOW shard: halo its last
        # plane's essential flag so dl[0] is zeroed when that row is an
        # identity row (matches build_line_tables' masking; shard 0 treats
        # the nonexistent plane below the domain as essential - its
        # cross-shard coupling is zero anyway). Review r3: the flag was
        # hardcoded False for s > 0.
        ess_dn = my(
            self._halo_up(g.ess[1][..., -1:, :].astype(jnp.int8))
        )[..., 0] > 0
        ess_prev = ess_prev.at[..., 0].set(
            jnp.where(first_global, True, ess_dn)
        )
        # ess of the plane above row j is essy[j+1] (local) or, for the
        # last row, the first plane of the shard above (or the closing
        # global plane - essential).
        essy_up = self._halo_dn(essy[..., :1])
        last_global = s_idx == self.n_sp - 1
        ess_next = jnp.concatenate(
            [essy[..., 1:],
             jnp.where(last_global, jnp.ones_like(essy[..., :1], dtype=bool),
                       essy_up)],
            axis=-1,
        )
        diag = jnp.where(essy, 1.0, diag)
        dl = jnp.where(essy | ess_prev, 0.0, dl)
        du = jnp.where(essy | ess_next, 0.0, du)
        fy = spike_tridiag_factor(dl, diag, du, self.axis, self.n_sp)
        return fx, fy, fz

    def _minv_apply(self, factors, r):
        """Exact M(w)^{-1} on the face-grid triple r = (rx, ry, rz) for
        tables built by _minv_factor."""
        from parelagmc_tpu.ops.tridiag import solve_lines

        fx, fy, fz = factors
        rx, ry, rz = r
        zx = solve_lines(*fx, rx)
        mv = lambda t: jnp.moveaxis(t, -3, -1)
        vm = lambda t: jnp.moveaxis(t, -1, -3)
        zz = vm(solve_lines(*fz, mv(rz)))
        my = lambda t: jnp.moveaxis(t, -2, -1)
        zy = jnp.moveaxis(
            spike_tridiag_apply(fy, my(ry), self.axis, self.n_sp), -1, -2
        )
        return zx, zy, zz

    def _slab_mg_state(self, g: _Grids, w, w_dn, blo_y):
        """Per-solve state of the slab-local coefMG: per-axis face-grid
        inverse mass diagonals of THIS slab's cells flattened into the
        slab mesh's face vector, then the standard struct_mg_setup ladder.
        Cut faces keep their true halo-coupled diagonal (restricted-
        Schwarz Dirichlet-ghost block, matching the true diag(S) row);
        essential and padded faces get dinv = 0. Computed ONCE per solve,
        before the CG while_loop (XLA does not hoist it out)."""
        from parelagmc_tpu.ops.coef_multigrid_structured import struct_mg_setup

        def line(bll, brr, ess, axis):
            c_lo = w * bll
            c_hi = w * brr
            zl = jnp.zeros_like(
                jax.lax.slice_in_dim(c_lo, 0, 1, axis=axis + c_lo.ndim)
            )
            diag = jnp.concatenate([c_lo, zl], axis=axis) + jnp.concatenate(
                [zl, c_hi], axis=axis
            )
            return jnp.where(
                ess | (diag <= 0),
                0.0,
                1.0 / jnp.where(diag <= 0, 1.0, diag),
            )

        dx = line(g.bll[0], g.brr[0], g.ess[0], -1)
        dz = line(g.bll[2], g.brr[2], g.ess[2], -3)
        # y faces: m + 1 planes. Plane j couples cell j-1 (halo w_dn/blo_y
        # for j = 0) and cell j; the top plane m couples the local last
        # cell and the up-shard's first cell (global closing plane on the
        # last shard: essential).
        w_lo = jnp.concatenate([w_dn, w[..., :-1, :]], axis=-2)
        brr_lo = jnp.concatenate([blo_y, g.brr[1][..., :-1, :]], axis=-2)
        diag_low = w_lo * brr_lo + w * g.bll[1]
        w_up = self._halo_dn(w[..., :1, :])
        bll_up = self._halo_dn(g.bll[1][..., :1, :])
        diag_top = w[..., -1:, :] * g.brr[1][..., -1:, :] + w_up * bll_up
        diag_y = jnp.concatenate([diag_low, diag_top], axis=-2)
        essy = g.ess[1]
        ess_up = self._halo_dn(essy[..., :1, :])
        last = jax.lax.axis_index(self.axis) == self.n_sp - 1
        ess_top = jnp.where(last, jnp.ones_like(ess_up), ess_up)
        ess_y = jnp.concatenate([essy, ess_top], axis=-2)
        dy = jnp.where(
            ess_y | (diag_y <= 0),
            0.0,
            1.0 / jnp.where(diag_y <= 0, 1.0, diag_y),
        )
        batch = w.shape[:-3]
        flat = jnp.concatenate(
            [
                dx.reshape(batch + (-1,)),
                dy.reshape(batch + (-1,)),
                dz.reshape(batch + (-1,)),
            ],
            axis=-1,
        )
        def cast(st):
            # Reduced-precision preconditioner state (coefmg_prec_dtype):
            # bf16 tables halve the V-cycle's bytes; CG stays in the
            # solve dtype (oracle: tests/test_darcy.py bf16 test).
            if self.mg_prec_dtype is None:
                return st
            pdt = jnp.dtype(self.mg_prec_dtype)
            return jax.tree.map(lambda a: a.astype(pdt), st)

        state = cast(struct_mg_setup(self.slab_mg, flat))
        if self.global_mg is None:
            return state, None
        # Global handoff-level dinv axes: the slabs' level-k grids tile the
        # full grid's level-k grid exactly (pair-aligned y), and the
        # duplicated cut planes carry identical values on both sides (both
        # equal the true global face diagonal), so concatenation along y -
        # dropping each slab's top y-face plane except the last - IS the
        # global coarse dinv. One all_gather per solve.
        gdx, gdy, gdz = state[self.k_handoff][0]
        agx = jax.lax.all_gather(gdx, self.axis)
        agy = jax.lax.all_gather(gdy, self.axis)
        agz = jax.lax.all_gather(gdz, self.axis)
        n = self.n_sp
        gx = jnp.concatenate([agx[s] for s in range(n)], axis=-2)
        gz = jnp.concatenate([agz[s] for s in range(n)], axis=-2)
        gy = jnp.concatenate(
            [agy[s][..., :-1, :] for s in range(n)] + [agy[n - 1][..., -1:, :]],
            axis=-2,
        )
        gflat = jnp.concatenate(
            [
                gx.reshape(batch + (-1,)),
                gy.reshape(batch + (-1,)),
                gz.reshape(batch + (-1,)),
            ],
            axis=-1,
        )
        return state, cast(struct_mg_setup(self.global_mg, gflat))

    def _slab_mg_apply(self, states, r):
        """Additive two-level Schwarz on the local cell-grid residual r:
        slab-local V-cycle(s) + (when enabled) a replicated global coarse
        V-cycle at the handoff level, restricted/prolonged through the
        slab ladder's own pair-aligned group transfers."""
        from parelagmc_tpu.ops.coef_multigrid_structured import (
            _prolong_cells,
            _restrict_cells,
            _v_cycle_grid,
            struct_s_apply,
            struct_v_cycle,
        )

        state, gstate = states
        rdt = r.dtype
        if self.mg_prec_dtype is not None:
            r = r.astype(jnp.dtype(self.mg_prec_dtype))
        batch = r.shape[:-3]
        rf = r.reshape(batch + (-1,))
        cycle = lambda b: struct_v_cycle(
            self.slab_mg, state, b, sweeps=self.mg_sweeps
        )
        z = cycle(rf)
        for _ in range(self.mg_cycles - 1):
            z = z + cycle(rf - struct_s_apply(self.slab_mg, state, z))
        z = z.reshape(r.shape)
        if gstate is None:
            return z.astype(rdt)
        rc = r
        for lvl in range(1, self.k_handoff + 1):
            rc = _restrict_cells(rc, self.slab_mg.levels[lvl], 3)
        ag = jax.lax.all_gather(rc, self.axis)
        rg = jnp.concatenate([ag[s] for s in range(self.n_sp)], axis=-2)
        zg = _v_cycle_grid(self.global_mg, gstate, rg, self.mg_sweeps, 0)
        m_k = self.slab_mg.levels[self.k_handoff].shape[1]
        s_idx = jax.lax.axis_index(self.axis)
        zc = jax.lax.dynamic_slice_in_dim(
            zg, s_idx * m_k, m_k, axis=zg.ndim - 2
        )
        for lvl in range(self.k_handoff, 0, -1):
            zc = _prolong_cells(zc, self.slab_mg.levels[lvl], 3)
        return (z + zc).astype(rdt)

    def _apply_b(self, g, u):
        """Cell values B u = sum of signed face differences; needs the
        above-shard's first y plane."""
        ux, uy, uz = u
        uy_up = self._halo_dn(uy[..., :1, :])
        uy_hi = jnp.concatenate([uy[..., 1:, :], uy_up], axis=-2)
        out = (
            ux[..., 1:] - ux[..., :-1]
            + uy_hi - uy
            + uz[..., 1:, :, :] - uz[..., :-1, :, :]
        )
        return jnp.where(g.pad_cell, 0.0, out)

    def _apply_bt(self, g, p):
        """Face grids B^T p = p[lo cell] - p[hi cell]; needs the
        below-shard's last cell plane."""
        pz = jnp.where(g.pad_cell, 0.0, p)
        zx = jnp.zeros_like(pz[..., :1])
        tx = jnp.concatenate([zx, pz], axis=-1) - jnp.concatenate(
            [pz, zx], axis=-1
        )
        p_dn = self._halo_up(pz[..., -1:, :])
        ty = jnp.concatenate([p_dn, pz[..., :-1, :]], axis=-2) - pz
        zz = jnp.zeros_like(pz[..., :1, :, :])
        tz = jnp.concatenate([zz, pz], axis=-3) - jnp.concatenate(
            [pz, zz], axis=-3
        )
        return (
            jnp.where(g.ess[0], 0.0, tx),
            jnp.where(g.ess[1], 0.0, ty),
            jnp.where(g.ess[2], 0.0, tz),
        )

    # -- the sharded solve ------------------------------------------------------
    def _run_cg(
        self, g: _Grids, apply_S, prec, vdot, rhs_s, x0t=None,
        want_r_true=False,
    ):
        """Preconditioned CG on the sharded Schur grids, SPMD-safe across
        the (dp, sp) mesh (uniform while_loop exit; see any_active).
        Returns (x, iterations, rnorm, bnorm, converged, r_true);
        r_true is the final true-residual VECTOR when want_r_true (the
        adjoint correction consumes it - computing it here means the
        convergence check shares the operator application instead of
        paying a second one), else None."""
        if x0t is None:
            x = jnp.zeros_like(rhs_s)
            r = rhs_s
        else:
            x = jnp.broadcast_to(x0t, rhs_s.shape)
            r = rhs_s - apply_S(x)
        z = prec(r)
        p = z
        rz = vdot(r, z)
        bn = jnp.sqrt(vdot(rhs_s, rhs_s))
        thresh = self.rtol * bn

        def any_active(rn):
            """Loop-continue flag, uniform across the WHOLE device mesh.
            vdot already makes rn identical within an sp row; with a
            sample (dp) axis the flag must ALSO be reduced across rows -
            a per-row jnp.any would let converged rows exit the
            while_loop early while others still issue the body's
            collectives, deadlocking the SPMD program (measured on the
            8-device CPU mesh: CollectivePermute rendezvous timeout)."""
            a = jnp.sum((rn > thresh).astype(jnp.int32))
            if self.n_dp > 1:
                a = jax.lax.psum(a, self.sample_axis)
            return a > 0

        def cond(st):
            it, x, r, p, rz, rn, go = st
            return (it < self.max_iters) & go

        re_ = self.restart_every

        def body(st):
            it, x, r, p, rz, rn, go = st
            Ap = apply_S(p)
            pAp = vdot(p, Ap)
            alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
            active = rn > thresh
            alpha = jnp.where(active, alpha, 0.0)
            ax = alpha[..., None, None, None]
            x = x + ax * p
            r = r - ax * Ap
            # True-residual restart (mirrors ops.solvers.pcg's
            # restart_every): the recurrence residual drifts below the
            # TRUE residual in f32 - at SPE10 contrast the recurrence can
            # pass rtol while the real residual is stuck near 5e-4 and
            # the flux QoI still carries the loose-rtol error (CLAUDE.md
            # root-cause). `it` is mesh-uniform, so the lax.cond predicate
            # is SPMD-uniform and the collectives inside apply_S are safe;
            # the S application only runs on restart iterations.
            restart = jnp.asarray(re_ > 0) & ((it + 1) % max(re_, 1) == 0)
            r = jax.lax.cond(
                restart, lambda _: rhs_s - apply_S(x), lambda _: r, None
            )
            z = prec(r)
            rz_new = vdot(r, z)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
            beta = jnp.where(restart, 0.0, beta)  # steepest-descent restart
            p = z + jnp.where(active, beta, 0.0)[..., None, None, None] * p
            rn_new = jnp.sqrt(vdot(r, r))
            return it + 1, x, r, p, rz_new, rn_new, any_active(rn_new)

        rn0 = jnp.sqrt(vdot(r, r))
        it0 = jnp.zeros((), dtype=jnp.int32)
        it, x, r, p, rz, rn, _ = jax.lax.while_loop(
            cond, body, (it0, x, r, p, rz, rn0, any_active(rn0))
        )
        # Verify claimed convergence against the TRUE residual, mirroring
        # ops.solvers.pcg (review r3): between restarts the f32 recurrence
        # drifts BELOW the true residual, so an exit triggered by the
        # recurrence can hand the managers' segmented continuation an
        # unverified converged=True with the QoI still carrying the
        # loose-residual error. The lax.cond predicate is psum-reduced over
        # every mesh axis (like any_active) so it is SPMD-uniform and the
        # collectives inside apply_S are rendezvous-safe.
        claimed = rn <= thresh
        if want_r_true:
            # The caller needs the true-residual vector regardless (adjoint
            # correction), so compute it unconditionally and the flag is
            # always verified.
            r_true = rhs_s - apply_S(x)
            rn = jnp.sqrt(vdot(r_true, r_true))
            verified = True
        else:
            r_true = None
            nclaimed = jnp.sum(claimed.astype(jnp.int32))
            if self.n_dp > 1:
                nclaimed = jax.lax.psum(nclaimed, self.sample_axis)
            verified = nclaimed > 0

            def _true_rn(_):
                r_t = rhs_s - apply_S(x)
                return jnp.sqrt(vdot(r_t, r_t))

            rn = jax.lax.cond(verified, _true_rn, lambda _: rn, None)
        # Same per-row 4x exit slack as ops.solvers.pcg: the true residual
        # generically sits a small factor above the recurrence that
        # triggered the exit; the failure class this flag exists for is
        # orders of magnitude.
        conv = rn <= thresh * jnp.where(verified & claimed, 4.0, 1.0)
        return x, it, rn, bn, conv, r_true

    def _local_solve(
        self, g: _Grids, w: jnp.ndarray, x0t=None, lam0t=None, adjoint=False
    ):
        """Inside shard_map: w is the local (batch, nz, m, nx) coefficient
        block; x0t an optional warm-start pressure grid in the internal
        p~ = -p convention (already sliced per shard); lam0t an optional
        adjoint warm start (no sign flip). Returns
        (Q, iterations, rnorm, converged, p~ grid[, lambda grid])."""
        w = jnp.where(g.pad_cell, 1.0, w)
        w_dn = self._halo_up(w[..., -1:, :])
        blo_y = self._halo_up(g.brr[1][..., -1:, :])
        bmid_y = self._halo_up(g.blr[1][..., -1:, :])

        mfac = self._minv_factor(g, w, w_dn, blo_y, bmid_y)
        minv = lambda r: self._minv_apply(mfac, r)
        f = tuple(
            jnp.broadcast_to(v, w.shape[:-3] + v.shape) for v in g.rhs_u
        )
        rhs_s = self._apply_b(g, minv(f)) - g.rhs_p

        axis = self.axis

        def vdot(a, b):
            return jax.lax.psum(
                jnp.sum(a * b, axis=(-1, -2, -3)), axis
            )

        apply_S = lambda p: self._apply_b(g, minv(self._apply_bt(g, p)))
        if self.precond == "coefmg":
            mg_state = self._slab_mg_state(g, w, w_dn, blo_y)
            prec = lambda r: self._slab_mg_apply(mg_state, r)
        else:
            # Jacobi on diag(S_bar), scaled by the sample's local amplitude
            # (sqrt(w) symmetric scaling, cf. darcy local_schur_scaling).
            sw = jnp.sqrt(w)
            prec = lambda r: sw * (r / g.sdiag) * sw

        x, it, rn, bn, conv, r_true = self._run_cg(
            g, apply_S, prec, vdot, rhs_s, x0t, want_r_true=adjoint
        )
        # Velocity and QoI (p~ = -p convention matches the unsharded path:
        # rhs_s was built as B Minv f - g for the system S p~ = rhs_s).
        bt = self._apply_bt(g, x)
        u = minv(tuple(fv - bv for fv, bv in zip(f, bt)))
        q = vdot(x, jnp.broadcast_to(g.obs_p, x.shape))
        for ua, oa in zip(u, g.obs_u):
            q = q + vdot(ua, jnp.broadcast_to(oa, ua.shape))
        rel = rn / jnp.where(bn == 0, 1.0, bn)
        lam = None
        if adjoint:
            # Goal-oriented correction, the sharded mirror of
            # DarcySolver._solve_cg_schur's config.adjoint_qoi path:
            # q_s = dQ/dp~ = obs_p - B M(w)^{-1} obs_u; solve the (same,
            # symmetric) Schur system S lam = q_s and add lam^T r_true.
            # The remaining QoI error is the PRODUCT of the two solves'
            # energy errors.
            cu = tuple(
                jnp.broadcast_to(v, w.shape[:-3] + v.shape) for v in g.obs_u
            )
            q_s = jnp.broadcast_to(
                g.obs_p, rhs_s.shape
            ) - self._apply_b(g, minv(cu))
            lam, it_a, rn_a, bn_a, conv_a, _ = self._run_cg(
                g, apply_S, prec, vdot, q_s, lam0t
            )
            # r_true came out of the primal _run_cg (want_r_true) - the
            # convergence check and the correction share one S application.
            q = q + vdot(lam, r_true)
            it = it + it_a
            rel = jnp.maximum(rel, rn_a / jnp.where(bn_a == 0, 1.0, bn_a))
            conv = conv & conv_a
        # Iterations broadcast to the batch so every output is uniformly
        # dp-sharded when a sample axis is present.
        it_b = jnp.broadcast_to(it, q.shape)
        if adjoint:
            return q, it_b, rel, conv, x, lam
        return q, it_b, rel, conv, x

    def _to_grid(self, v: jnp.ndarray, pad_value: float) -> jnp.ndarray:
        """(batch, n_s) flat cell field -> padded (batch, nz, ny_pad, nx)."""
        nx, ny, nz = self.shape
        batch = v.shape[:-1]
        vg = v.reshape(batch + (nz, ny, nx))
        if self.pad:
            vg = jnp.concatenate(
                [
                    vg,
                    jnp.full(
                        batch + (nz, self.pad, nx), pad_value, dtype=vg.dtype
                    ),
                ],
                axis=-2,
            )
        return vg

    def solve_fwd(
        self,
        w: jnp.ndarray,
        p0: Optional[jnp.ndarray] = None,
        return_pressure: bool = False,
        lam0: Optional[jnp.ndarray] = None,
        adjoint: bool = False,
    ):
        """Solve for a batch of coefficient fields (batch, n_s) given in
        the UNSHARDED flat cell order; returns (Q, iterations, relres,
        converged[, p][, lam]) with iterations broadcast to the batch and p
        the physical cell pressure (flat, unsharded order) when requested.
        p0 optionally warm-starts CG from a physical pressure on the SAME
        level (e.g. the prolongated coarse pressure of an MLMC pair - the
        spatial analog of DarcySolver.solve_fwd_warm); with adjoint=True
        the QoI is goal-oriented-corrected (config.adjoint_qoi) and lam0
        optionally warm-starts the adjoint solve (lam returned after p).
        The per-shard memory footprint of all solver state is ~1/n_sp of the
        unsharded solve's; with n_dp > 1 the batch additionally shards
        over the sample axis."""
        from jax import shard_map

        if lam0 is not None and not adjoint:
            raise ValueError("lam0 requires adjoint=True")
        nx, ny, nz = self.shape
        batch = w.shape[:-1]
        wg = self._to_grid(w, 1.0)
        if self.n_dp > 1 and (not batch or batch[0] % self.n_dp):
            raise ValueError(
                f"leading batch dim must be a multiple of n_dp={self.n_dp}"
            )
        x0g = None if p0 is None else self._to_grid(-p0, 0.0)  # p~ = -p
        lam0g = None if lam0 is None else self._to_grid(lam0, 0.0)

        key = (len(batch), p0 is not None, return_pressure,
               adjoint, lam0 is not None)
        if key not in self._jit_solve:
            axis = self.axis
            spec_y = {
                "bll": (P(None, axis, None),) * 3,
                "blr": (P(None, axis, None),) * 3,
                "brr": (P(None, axis, None),) * 3,
                "ess": (P(None, axis, None),) * 3,
                "rhs_u": (P(None, axis, None),) * 3,
                "obs_u": (P(None, axis, None),) * 3,
                "rhs_p": P(None, axis, None),
                "obs_p": P(None, axis, None),
                "pad_cell": P(None, axis, None),
                "sdiag": P(None, axis, None),
            }
            g_spec = _Grids(**spec_y)
            nb = len(batch)
            bspec = [None] * nb
            if self.n_dp > 1:
                bspec[0] = self.sample_axis
            w_spec = P(*(bspec + [None, axis, None]))
            b_out = P(*bspec)
            out_spec = (b_out, b_out, b_out, b_out)
            if return_pressure:
                out_spec = out_spec + (w_spec,)
                if adjoint:
                    out_spec = out_spec + (w_spec,)

            have_x0, have_l0 = p0 is not None, lam0 is not None

            def run(g, wloc, *opts):
                x0loc = opts[0] if have_x0 else None
                lam0loc = opts[-1] if have_l0 else None
                out = self._local_solve(
                    g, wloc, x0loc, lam0loc, adjoint=adjoint
                )
                if return_pressure:
                    return out[: 6 if adjoint else 5]
                return out[:4]

            in_specs = (g_spec, w_spec) + (w_spec,) * (
                int(have_x0) + int(have_l0)
            )
            sharded = shard_map(
                run,
                mesh=self.mesh_dev,
                in_specs=in_specs,
                out_specs=out_spec,
                check_vma=False,
            )
            self._jit_solve[key] = jax.jit(sharded)
        args = (self.grids, wg)
        args += (x0g,) if p0 is not None else ()
        args += (lam0g,) if lam0 is not None else ()
        out = self._jit_solve[key](*args)
        if not return_pressure:
            return out
        if adjoint:
            q, it, rel, conv, xg, lamg = out
            lam = lamg[..., :, :ny, :].reshape(batch + (self.n_s,))
        else:
            q, it, rel, conv, xg = out
        p = (-xg)[..., :, :ny, :].reshape(batch + (self.n_s,))
        if adjoint:
            return q, it, rel, conv, p, lam
        return q, it, rel, conv, p
