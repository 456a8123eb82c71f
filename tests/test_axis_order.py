"""Axis-order relabeling (config.axis_order): the device grid layout
permutation must leave the PHYSICS identical - same QoI for the same
physical coefficient field and the same per-level dof counts - because it
only relabels which mesh axis is the fast (minor) array dimension.

Oracle: build the same box problem with and without a permutation, feed
the SAME physical cell field (re-flattened to each layout), and compare
solve_fwd QoIs at every level in f64. Exercises the full axis-coupled
input surface: kinv_ref re-flattening, boundary-side attribute remapping
(ess/obs/inflow - eff_perm would be grossly wrong if any side were
mislabeled), qoi_point, lengths/spacings.
"""

import dataclasses

import numpy as np
import pytest

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.problems import (
    build_problem,
    fine_mesh_spec,
    permute_cell_field,
    resolve_axis_order,
)


def test_resolve_axis_order_auto_spe10():
    assert resolve_axis_order("auto", (60, 220, 85)) == (1, 0, 2)
    assert resolve_axis_order("auto", (16, 16, 16)) == (0, 1, 2)
    assert resolve_axis_order(None, (60, 220, 85)) == (0, 1, 2)
    with pytest.raises(ValueError):
        resolve_axis_order((0, 0, 2), (4, 4, 4))


def test_axis_order_rejects_bad_line_axes_letters():
    """_permute_config_axes validates coefmg_line_axes letters instead of
    crashing with an opaque ValueError from str.index (review r3)."""
    cfg = ProblemConfig(
        mesh="box", ncells=(2, 2, 2), refinements=1, dtype="float64",
        axis_order=(1, 0, 2),
    )
    cfg.darcy_solver.coefmg_line_axes = "xq"
    with pytest.raises(ValueError, match="unknown axis letter"):
        build_problem(cfg)


def test_permute_cell_field_indexing():
    """permute_cell_field must satisfy: value at (new layout flat index of
    cell (i0, i1, i2) in new axes) == value at original flat index of the
    same physical cell."""
    ncells = (3, 4, 5)  # x, y, z
    order = (1, 2, 0)  # new x = orig y, new y = orig z, new z = orig x
    n = int(np.prod(ncells))
    rng = np.random.default_rng(0)
    f = rng.normal(size=n)
    g = permute_cell_field(f, ncells, order)
    new_n = tuple(ncells[a] for a in order)

    def flat(nc, i):  # x-fastest
        return i[0] + nc[0] * (i[1] + nc[1] * i[2])

    for _ in range(20):
        io = tuple(rng.integers(0, s) for s in ncells)  # orig (ix, iy, iz)
        ip = tuple(io[order[k]] for k in range(3))
        assert g[flat(new_n, ip)] == f[flat(ncells, io)]
    # per-axis (n, d) column permutation
    fd = rng.normal(size=(n, 3))
    gd = permute_cell_field(fd, ncells, order)
    io = (1, 2, 3)
    ip = tuple(io[order[k]] for k in range(3))
    np.testing.assert_array_equal(
        gd[flat(new_n, ip)], fd[flat(ncells, io)][list(order)]
    )


def test_axis_order_bayes_obs_equivalence():
    """Observation functionals (bayes_obs_coords are PHYSICAL points) must
    give identical G(w) under an axis relabel — guards the obs-coords
    column permutation in _permute_config_axes."""
    from parelagmc_tpu.uq import BayesianInverseProblem

    base_cfg = ProblemConfig(
        mesh="box",
        ncells=(2, 3, 1),
        lengths=(2.0, 3.0, 1.0),
        refinements=2,
        dtype="float64",
        bayes_num_obs=2,
        bayes_obs_coords=(0.5, 1.0, 0.25, 1.5, 2.5, 0.75),
        bayes_eps=0.3,
    )
    base_cfg.darcy_solver.relative_tolerance = 1e-12
    base_cfg.darcy_solver.max_iterations = 400
    fine_ncells, _ = fine_mesh_spec(base_cfg)
    order = (1, 0, 2)
    base = build_problem(base_cfg)
    perm = build_problem(dataclasses.replace(base_cfg, axis_order=order))
    bip_b = BayesianInverseProblem(base.solver, base.sampler, base.config, base.dtype)
    bip_p = BayesianInverseProblem(perm.solver, perm.sampler, perm.config, perm.dtype)
    rng = np.random.default_rng(7)
    for lvl in range(base.hierarchy.nlevels):
        mesh_l = base.hierarchy.levels[lvl].mesh
        w = np.exp(rng.normal(size=(1, mesh_l.num_cells)) * 0.5)
        w_p = permute_cell_field(w[0], tuple(mesh_l.shape), order)[None]
        G_b = np.asarray(bip_b.compute_G(lvl, w)[0])
        G_p = np.asarray(bip_p.compute_G(lvl, w_p)[0])
        np.testing.assert_allclose(G_b, G_p, rtol=1e-8, err_msg=f"level {lvl}")


@pytest.mark.parametrize("qoi", ["eff_perm", "local_avg_p"])
@pytest.mark.parametrize("axis_order", [(1, 0, 2), (2, 0, 1), "auto"])
def test_axis_order_qoi_equivalence(qoi, axis_order):
    base_cfg = ProblemConfig(
        mesh="box",
        ncells=(2, 3, 1),
        lengths=(2.0, 3.0, 1.0),
        refinements=2,
        dtype="float64",
        qoi=qoi,
        qoi_point=(1.0, 1.5, 0.5),
        qoi_eps=0.4,
    )
    base_cfg.darcy_solver.relative_tolerance = 1e-12
    base_cfg.darcy_solver.max_iterations = 400
    fine_ncells, _ = fine_mesh_spec(base_cfg)  # (8, 12, 4)
    rng = np.random.default_rng(3)
    kinv = np.exp(rng.normal(size=(int(np.prod(fine_ncells)), 3)) * 0.4)

    base = build_problem(base_cfg, kinv_ref=kinv)
    perm = build_problem(
        dataclasses.replace(base_cfg, axis_order=axis_order), kinv_ref=kinv
    )
    order = resolve_axis_order(axis_order, fine_ncells)
    assert tuple(perm.hierarchy.levels[0].mesh.shape) == tuple(
        fine_ncells[a] for a in order
    )

    for lvl in range(base.hierarchy.nlevels):
        mesh_l = base.hierarchy.levels[lvl].mesh
        nc_l = tuple(mesh_l.shape)
        w = np.exp(rng.normal(size=(1, mesh_l.num_cells)) * 0.5)
        w_p = permute_cell_field(w[0], nc_l, order)[None]
        q_b, c_b, _ = base.solver.solve_fwd(lvl, w)[:3]
        q_p, c_p, _ = perm.solver.solve_fwd(lvl, w_p)[:3]
        assert int(c_b) == int(c_p)
        np.testing.assert_allclose(
            np.asarray(q_b), np.asarray(q_p), rtol=1e-8,
            err_msg=f"level {lvl} order {order} qoi {qoi}",
        )
