"""Spatial domain decomposition of ONE realization across a device mesh.

The reference's "model parallel" axis: the mesh is partitioned across MPI
ranks (mfem::ParMesh), dof ownership tracked by ParELAG SharingMaps, and
every SpMV/Krylov step is a collective with halo exchange
(/root/reference/src/PDESampler.cpp:395-398, src/DarcySolver.cpp:651-675).
SURVEY.md section 5.7: on accelerators this axis is only needed when a
single fine level no longer fits (or no longer saturates) one device;
sample batching stays the primary axis. This module supplies the
equivalent:

* Setup (host): renumber dofs into contiguous slabs of a 1D spatial
  partition (any contiguous-by-coordinate order works; callers pass a slab
  id per dof). Because slabs are contiguous in space and the operators are
  low-order FEM, a row only couples its own and the two NEIGHBOR slabs -
  the halo pattern of a 1D domain decomposition. Per shard we precompute a
  local ELL whose column space is [own dofs | halo from below | halo from
  above], plus the static send-index lists.

* Runtime (device, inside shard_map over the "sp" axis): halo exchange is
  two `ppermute` shifts (up/down neighbors) of statically-shaped,
  padded boundary buffers - the SharingMap::Distribute analog; dot
  products in the sharded PCG are `psum` over the axis - the
  MPI_Allreduce analog. Everything is static shapes and static collective
  patterns, exactly what XLA wants (no ParMoonolith-style dynamic
  communication survives to runtime).

Validated against the unsharded solve on the virtual 8-device CPU mesh
(tests/test_spatial.py) - the analog of oversubscribed mpirun.

This generic-CSR form is the prototype / oracle; the PRODUCTION spatial
axis is parallel/spatial_darcy.SpatialDarcy (tensor-grid Darcy Schur CG
with exact SPIKE line solves and the two-level Schwarz coefMG), reachable
from config.darcy_solver.spatial_shards and measured by
examples/spatial_scaling.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P


class ShardedOperator(NamedTuple):
    """Static per-shard SpMV data, stacked over the leading shard axis."""

    cols: jnp.ndarray  # (n_sp, n_loc, K) int32, columns into [own|halo_dn|halo_up]
    vals: jnp.ndarray  # (n_sp, n_loc, K)
    send_dn: jnp.ndarray  # (n_sp, H) int32 local indices this shard sends down
    send_up: jnp.ndarray  # (n_sp, H)
    n_local: int
    n_halo: int  # H (max per direction, padded)
    perm: np.ndarray  # global renumbering: new[i] = old dof perm[i]
    axis: str


def build_sharded_operator(
    A: sp.spmatrix,
    slab: np.ndarray,
    n_sp: int,
    dtype=jnp.float32,
    axis: str = "sp",
) -> ShardedOperator:
    """Partition symmetric CSR `A` by the per-row slab ids (0..n_sp-1,
    contiguous in space). Requires the 1D-decomposition property: every
    nonzero A[i, j] has |slab[i] - slab[j]| <= 1."""
    A = A.tocsr()
    n = A.shape[0]
    slab = np.asarray(slab, dtype=np.int64)
    counts = np.bincount(slab, minlength=n_sp)
    if counts.min() <= 0:
        raise ValueError("every slab must own at least one dof")
    if counts.max() != counts.min():
        raise ValueError(
            f"slabs must be balanced for static shapes (got {counts})"
        )
    n_loc = int(counts[0])
    perm = np.argsort(slab, kind="stable")  # new -> old
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    B = A[perm][:, perm].tocsr()  # renumbered: shard s owns rows [s*n_loc, ...)
    coo = B.tocoo()
    s_r, s_c = coo.row // n_loc, coo.col // n_loc
    if np.abs(s_r - s_c).max() > 1:
        raise ValueError("operator couples non-adjacent slabs: not a 1D decomposition")

    # Halo dofs each shard needs from its neighbors (global new ids).
    need_dn = [
        np.unique(coo.col[(s_r == s) & (s_c == s - 1)]) for s in range(n_sp)
    ]
    need_up = [
        np.unique(coo.col[(s_r == s) & (s_c == s + 1)]) for s in range(n_sp)
    ]
    H = max([1] + [x.size for x in need_dn + need_up])
    send_dn = np.zeros((n_sp, H), dtype=np.int32)  # what s sends to s-1 (= s-1's need_up)
    send_up = np.zeros((n_sp, H), dtype=np.int32)  # what s sends to s+1
    for s in range(n_sp):
        if s + 1 < n_sp:
            idx = need_dn[s + 1] - s * n_loc  # local in shard s
            send_up[s, : idx.size] = idx
        if s - 1 >= 0:
            idx = need_up[s - 1] - s * n_loc
            send_dn[s, : idx.size] = idx

    # Per-shard ELL with columns remapped to [own | halo_dn | halo_up].
    K = int(np.diff(B.indptr).max())
    cols = np.zeros((n_sp, n_loc, K), dtype=np.int32)
    vals = np.zeros((n_sp, n_loc, K), dtype=np.float64)
    for s in range(n_sp):
        lo, hi = s * n_loc, (s + 1) * n_loc
        sub = B[lo:hi]
        cmap = np.zeros(n, dtype=np.int64)
        cmap[lo:hi] = np.arange(n_loc)
        cmap[need_dn[s]] = n_loc + np.arange(need_dn[s].size)
        cmap[need_up[s]] = n_loc + H + np.arange(need_up[s].size)
        rr = np.repeat(np.arange(n_loc), np.diff(sub.indptr))
        slot = np.arange(sub.nnz) - np.repeat(sub.indptr[:-1], np.diff(sub.indptr))
        cols[s, rr, slot] = cmap[sub.indices]
        vals[s, rr, slot] = sub.data
        # Padding slots point at local 0 with value 0 (safe).
    return ShardedOperator(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals, dtype=dtype),
        send_dn=jnp.asarray(send_dn),
        send_up=jnp.asarray(send_up),
        n_local=n_loc,
        n_halo=H,
        perm=perm,
        axis=axis,
    )


def _halo_exchange(op: ShardedOperator, x: jnp.ndarray, n_sp: int) -> jnp.ndarray:
    """[x | halo_dn | halo_up] for this shard (inside shard_map; x is the
    local (..., n_local) block, op.* are the per-shard slices)."""
    axis = op.axis
    up = jnp.take(x, op.send_up, axis=-1)  # to shard s+1
    dn = jnp.take(x, op.send_dn, axis=-1)  # to shard s-1
    # halo_dn on shard s = what s-1 sent up; halo_up = what s+1 sent down.
    halo_dn = jax.lax.ppermute(up, axis, [(i, i + 1) for i in range(n_sp - 1)])
    halo_up = jax.lax.ppermute(dn, axis, [(i, i - 1) for i in range(1, n_sp)])
    return jnp.concatenate([x, halo_dn, halo_up], axis=-1)


def spmv_sharded(op: ShardedOperator, x: jnp.ndarray, n_sp: int) -> jnp.ndarray:
    """y = A x on the local block (inside shard_map)."""
    xh = _halo_exchange(op, x, n_sp)
    g = jnp.take(xh, op.cols.reshape(-1), axis=-1).reshape(
        xh.shape[:-1] + op.cols.shape
    )
    return jnp.sum(g * op.vals, axis=-1)


def pcg_sharded(
    apply_A: Callable,
    b: jnp.ndarray,
    axis: str,
    prec: Optional[Callable] = None,
    max_iters: int = 300,
    rtol: float = 1e-6,
    atol: float = 1e-30,
):
    """Batched PCG whose vectors are spatially sharded over `axis`: local
    dot products are psum-reduced (the MPI_Allreduce analog in the
    reference's Krylov loops). Runs inside shard_map."""
    if prec is None:
        prec = lambda r: r

    def vdot(u, v):
        return jax.lax.psum(jnp.sum(u * v, axis=-1), axis)

    x = jnp.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = vdot(r, z)
    b_norm = jnp.sqrt(vdot(b, b))
    thresh = jnp.maximum(rtol * b_norm, atol)

    def cond(state):
        it, x, r, p, rz, rn = state
        return (it < max_iters) & jnp.any(rn > thresh)

    def body(state):
        it, x, r, p, rz, rn = state
        Ap = apply_A(p)
        pAp = vdot(p, Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        active = rn > thresh
        alpha = jnp.where(active, alpha, 0.0)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = prec(r)
        rz_new = vdot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p = z + jnp.where(active, beta, 0.0)[..., None] * p
        rn = jnp.sqrt(vdot(r, r))
        return it + 1, x, r, p, rz_new, rn

    it0 = jnp.zeros((), dtype=jnp.int32)
    rn0 = jnp.sqrt(vdot(r, r))
    it, x, r, p, rz, rn = jax.lax.while_loop(
        cond, body, (it0, x, r, p, rz, rn0)
    )
    return x, it


class SpatialSolver:
    """Spatially-sharded batched PCG for one SPD operator (e.g. the SPDE
    sampler's reduced H(div) system at the finest level): the solution
    state, residuals and SpMV halos live sharded over the 'sp' axis; only
    scalars cross shards outside the halo pattern."""

    def __init__(
        self,
        A: sp.spmatrix,
        points: np.ndarray,
        devices: Optional[Sequence] = None,
        dtype=jnp.float32,
        axis: str = "sp",
    ):
        """`points`: (n, d) dof locations driving the slab partition."""
        if devices is None:
            devices = jax.devices()
        self.mesh = Mesh(np.asarray(devices), (axis,))
        self.n_sp = len(devices)
        self.axis = axis
        A = A.tocsr()
        self.n = A.shape[0]
        # Pad with decoupled identity dofs to a multiple of the shard count
        # (static equal-size slabs; padded dofs sort to the last slab).
        pad = (-self.n) % self.n_sp
        if pad:
            A = sp.block_diag([A, sp.eye(pad)]).tocsr()
            points = np.vstack(
                [points, np.full((pad, points.shape[1]), np.inf)]
            )
        slab = slab_partition(points, self.n_sp)
        self.op = build_sharded_operator(A, slab, self.n_sp, dtype, axis)
        d = np.asarray(A.diagonal())[self.op.perm]
        self._dinv = jnp.asarray(
            (1.0 / np.where(d == 0, 1.0, d)).reshape(self.n_sp, -1), dtype=dtype
        )

    def solve(self, b: np.ndarray, max_iters: int = 300, rtol: float = 1e-6):
        """Solve A x = b for (..., n) right-hand sides (original dof order).
        Returns (x, iterations)."""
        from jax import shard_map

        op, n_sp, axis = self.op, self.n_sp, self.axis
        b = np.asarray(b)
        pad = op.perm.size - self.n
        if pad:
            b = np.concatenate(
                [b, np.zeros(b.shape[:-1] + (pad,))], axis=-1
            )
        b = jnp.asarray(b[..., op.perm], dtype=self._dinv.dtype)
        bs = b.reshape(b.shape[:-1] + (n_sp, op.n_local))
        bs = jnp.moveaxis(bs, -2, 0)  # (n_sp, ..., n_local)

        def local(op_cols, op_vals, send_dn, send_up, dinv, b_loc):
            # Leading shard axis of size 1 inside the shard -> squeeze.
            o = ShardedOperator(
                cols=op_cols[0], vals=op_vals[0], send_dn=send_dn[0],
                send_up=send_up[0], n_local=op.n_local, n_halo=op.n_halo,
                perm=op.perm, axis=axis,
            )
            x, it = pcg_sharded(
                lambda v: spmv_sharded(o, v, n_sp),
                b_loc[0],
                axis,
                prec=lambda r: r * dinv[0],
                max_iters=max_iters,
                rtol=rtol,
            )
            return x[None], it[None]

        sharded = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
        xs, its = sharded(
            op.cols, op.vals, op.send_dn, op.send_up, self._dinv, bs
        )
        x = jnp.moveaxis(xs, 0, -2).reshape(b.shape)
        inv = np.empty_like(self.op.perm)
        inv[self.op.perm] = np.arange(self.op.perm.size)
        return np.asarray(x)[..., inv][..., : self.n], int(np.max(np.asarray(its)))


def slab_partition(points: np.ndarray, n_sp: int, axis_dim: Optional[int] = None):
    """Balanced contiguous 1D slabs by coordinate quantile along the longest
    (or given) axis - the partitioner for spatial decomposition. Returns
    per-point slab ids with exactly n/n_sp points each (n divisible)."""
    points = np.asarray(points)
    if axis_dim is None:
        spans = points.max(axis=0) - points.min(axis=0)
        axis_dim = int(np.argmax(spans))
    n = points.shape[0]
    if n % n_sp:
        raise ValueError(f"{n} dofs not divisible into {n_sp} equal slabs")
    order = np.argsort(points[:, axis_dim], kind="stable")
    slab = np.empty(n, dtype=np.int64)
    slab[order] = np.arange(n) // (n // n_sp)
    return slab
