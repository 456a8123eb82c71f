"""Spatial domain decomposition (parallel/spatial.py): one realization's
solve sharded over the virtual 8-device mesh, validated against the
unsharded solve - the analog of the reference's ParMesh + SharingMap
halo exchange (PDESampler.cpp:395-398) under oversubscribed mpirun."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.mesh.mfem_io import read_mfem_mesh
from parelagmc_tpu.parallel.spatial import (
    SpatialSolver,
    build_sharded_operator,
    slab_partition,
)

MESHES = "/root/reference/meshes"


def _sampler_system():
    """The unstructured SPDE sampler's reduced SPD system + face points."""
    from parelagmc_tpu.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu.unstructured import UnstructuredSPDESampler

    gm = read_mfem_mesh(f"{MESHES}/cube_tet.mesh")
    hier = build_simplicial_hierarchy(gm, 3)
    lvl = hier.levels[0]
    ess = lvl.bdr_attr > 0
    M = lvl.mass_csr()
    B = lvl.b_csr()
    A = (M + 25.0 * (B.T @ sp.diags(1.0 / lvl.W) @ B)).tolil()
    idx = np.nonzero(ess)[0]
    A[idx, :] = 0.0
    A[:, idx] = 0.0
    A[idx, idx] = 1.0
    # Face points ~ average of adjacent cell centers (owner twice on the
    # boundary) - slab-partition-consistent with the cell geometry.
    conn = np.stack(lvl.mesh.elements)
    cc = lvl.mesh.vertices[conn].mean(axis=1)
    other = np.where(lvl.face_signs[:, 1] != 0.0, lvl.face_cells[:, 1],
                     lvl.face_cells[:, 0])
    pts = 0.5 * (cc[lvl.face_cells[:, 0]] + cc[other])
    return A.tocsr(), pts


def test_slab_partition_balanced_contiguous():
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(64, 3))
    slab = slab_partition(pts, 8)
    assert np.bincount(slab).tolist() == [8] * 8
    # Contiguity in the split coordinate: slab id is monotone in it.
    a = int(np.argmax(pts.max(0) - pts.min(0)))
    order = np.argsort(pts[:, a], kind="stable")
    assert np.all(np.diff(slab[order]) >= 0)


def test_sharded_solve_matches_unsharded():
    A, pts = _sampler_system()
    solver = SpatialSolver(A, pts, dtype=jnp.float64)
    assert solver.n_sp == 8
    rng = np.random.default_rng(3)
    b = rng.standard_normal((4, A.shape[0]))  # batched rhs
    x, iters = solver.solve(b, max_iters=2000, rtol=1e-11)
    x_ref = np.stack([spla.spsolve(A.tocsc(), b[i]) for i in range(4)])
    np.testing.assert_allclose(x, x_ref, rtol=1e-6, atol=1e-9)
    assert iters > 0


def test_sharded_operator_rejects_non_1d_coupling():
    # A dense row couples every slab: must be rejected at setup.
    n = 32
    A = sp.eye(n).tolil()
    A[0, :] = 1.0
    A[:, 0] = 1.0
    pts = np.arange(n, dtype=np.float64)[:, None]
    slab = slab_partition(pts, 8)
    with pytest.raises(ValueError, match="non-adjacent"):
        build_sharded_operator(A.tocsr(), slab, 8, jnp.float64)


def test_padding_to_shard_multiple():
    # n not divisible by 8: identity-padded dofs keep slabs equal and the
    # returned solution is truncated back to n.
    n = 30
    main = 2.0 + np.arange(n) * 0.01
    A = sp.diags([np.full(n - 1, -0.5), main, np.full(n - 1, -0.5)], [-1, 0, 1])
    pts = np.arange(n, dtype=np.float64)[:, None]
    solver = SpatialSolver(A.tocsr(), pts, dtype=jnp.float64)
    b = np.ones(n)
    x, _ = solver.solve(b, rtol=1e-12, max_iters=500)
    np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), b), rtol=1e-8)
