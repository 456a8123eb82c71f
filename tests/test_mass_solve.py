import numpy as np
import pytest

import jax.numpy as jnp

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy, build_mixed_level
from parelagmc_tpu.mesh import make_box_mesh
from parelagmc_tpu.mesh.structured import StructuredMesh
from parelagmc_tpu.ops.mass_solve import build_mass_tridiag_solver
from parelagmc_tpu.physics import DarcySolver

DT = jnp.float64


@pytest.mark.parametrize(
    "ncells,lengths",
    [((4, 3), (1.0, 2.0)), ((3, 2, 4), (1.0, 1.5, 0.5))],
)
def test_mass_tridiag_solve_matches_dense(ncells, lengths):
    mesh = make_box_mesh(ncells, lengths=lengths)
    lvl = build_mixed_level(mesh)
    d = mesh.dim
    ess = lvl.ess_faces(np.ones(2 * d, dtype=int))  # all boundary essential
    solver = build_mass_tridiag_solver(lvl, ess, dtype=DT)
    rng = np.random.default_rng(0)
    w = np.exp(rng.normal(size=(3, lvl.n_s)))
    rhs = rng.normal(size=(3, lvl.n_u))
    rhs[:, ess] = 0.0
    z = np.asarray(solver(jnp.asarray(w), jnp.asarray(rhs)))
    for b in range(3):
        M = lvl.mass_csr(w[b]).toarray()
        keep = ~ess
        Mi = M.copy()
        Mi[ess, :] = 0.0
        Mi[:, ess] = 0.0
        Mi[np.nonzero(ess)[0], np.nonzero(ess)[0]] = 1.0
        np.testing.assert_allclose(z[b], np.linalg.solve(Mi, rhs[b]), atol=1e-11)


def test_mass_tridiag_partial_ess_and_kinv():
    mesh = make_box_mesh((3, 3, 3), lengths=(2.0, 2.0, 2.0))
    lvl = build_mixed_level(mesh)
    ess = lvl.ess_faces(np.array([0, 1, 1, 1, 1, 0]))  # Darcy golden BCs
    rng = np.random.default_rng(1)
    kinv = np.exp(rng.normal(size=(lvl.n_s, 3)))
    solver = build_mass_tridiag_solver(lvl, ess, kinv_ref=kinv, dtype=DT)
    w = np.exp(rng.normal(size=(2, lvl.n_s)))
    rhs = rng.normal(size=(2, lvl.n_u))
    rhs[:, ess] = 0.0
    z = np.asarray(solver(jnp.asarray(w), jnp.asarray(rhs)))
    # Dense oracle with anisotropic static scaling baked per axis.
    face_ax = mesh.face_axis()
    for b in range(2):
        rows = np.repeat(np.arange(lvl.n_u), lvl.m_cols.shape[1])
        vals = (
            lvl.m_vals
            * kinv[lvl.m_cells, face_ax[:, None]]
            * w[b][lvl.m_cells]
        ).ravel()
        import scipy.sparse as sp

        M = sp.csr_matrix(
            (vals, (rows, lvl.m_cols.ravel())), shape=(lvl.n_u, lvl.n_u)
        ).toarray()
        M[ess, :] = 0.0
        M[:, ess] = 0.0
        M[np.nonzero(ess)[0], np.nonzero(ess)[0]] = 1.0
        np.testing.assert_allclose(z[b], np.linalg.solve(M, rhs[b]), atol=1e-11)


def test_cg_schur_matches_minres():
    mesh = make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 1)
    cfg1 = ProblemConfig(refinements=0)
    cfg1.darcy_solver.name = "cg-schur"
    cfg1.darcy_solver.relative_tolerance = 1e-11
    cfg2 = ProblemConfig(refinements=0)
    cfg2.darcy_solver.name = "minres-bj"
    cfg2.darcy_solver.relative_tolerance = 1e-11
    s1 = DarcySolver(hier, cfg1, DT)
    s2 = DarcySolver(hier, cfg2, DT)
    rng = np.random.default_rng(2)
    w = jnp.asarray(np.exp(rng.normal(size=(3, hier.levels[0].n_s))))
    Q1, c1, i1, p1 = s1.solve_fwd(0, w, return_pressure=True)
    Q2, c2, i2, p2 = s2.solve_fwd(0, w, return_pressure=True)
    np.testing.assert_allclose(np.asarray(Q1), np.asarray(Q2), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-6)
    # The Schur path must converge in far fewer outer iterations.
    assert int(i1.iterations) < int(i2.iterations) / 2


def test_cg_schur_iteration_count():
    mesh = make_box_mesh((8, 8, 8), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 1)
    cfg = ProblemConfig(refinements=0)
    solver = DarcySolver(hier, cfg, DT)
    rng = np.random.default_rng(3)
    w = jnp.asarray(np.exp(rng.normal(size=(4, hier.levels[0].n_s))))
    Q, cost, info = solver.solve_fwd(0, w)
    assert bool(info.converged.all())
    assert int(info.iterations) < 40


@pytest.mark.parametrize("variant", ["thomas", "pallas"])
def test_mass_tridiag_scan_variants_match_dense(variant, monkeypatch):
    """The line-solve routes other than the default tridiagonal_solve
    (sequential Thomas scan / the Pallas Triton kernel, in Pallas'
    interpreter on the CPU) match the dense oracle through
    MassTridiagSolver's prepared-table path."""
    import functools

    from parelagmc_tpu.ops import tridiag

    route = {"pallas": "triton"}.get(variant, variant)
    if route == "triton":
        monkeypatch.setattr(
            tridiag, "_thomas_rows",
            functools.partial(tridiag._thomas_rows, interpret=True,
                              block_lines=16),
        )
    mesh = make_box_mesh((5, 4, 3), lengths=(1.0, 2.0, 0.5))
    lvl = build_mixed_level(mesh)
    ess = lvl.ess_faces(np.array([1, 0, 1, 0, 1, 1]))
    solver = build_mass_tridiag_solver(lvl, ess, dtype=DT)
    rng = np.random.default_rng(4)
    w = np.exp(2.0 * rng.normal(size=(2, lvl.n_s)))
    rhs = rng.normal(size=(2, lvl.n_u))
    rhs[:, ess] = 0.0
    with tridiag.route_override(route):
        z = np.asarray(solver(jnp.asarray(w), jnp.asarray(rhs)))
    for b in range(2):
        M = lvl.mass_csr(w[b]).toarray()
        Mi = M.copy()
        Mi[ess, :] = 0.0
        Mi[:, ess] = 0.0
        Mi[np.nonzero(ess)[0], np.nonzero(ess)[0]] = 1.0
        np.testing.assert_allclose(z[b], np.linalg.solve(Mi, rhs[b]), atol=1e-10)
