"""Spatially-sharded Darcy Schur solves vs the unsharded DarcySolver
(VERDICT r2 item 3: spatial DD integrated with the REAL operators, not a
generic CSR prototype). Runs on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import build_geometric_hierarchy_from_fine
from parelagmc_tpu.mesh.factories import make_box_mesh
from parelagmc_tpu.parallel.spatial_darcy import SpatialDarcy, spike_tridiag_solve
from parelagmc_tpu.physics.darcy import DarcySolver

N_SP = 8


def test_spike_tridiag_exact():
    rng = np.random.default_rng(0)
    m, lines = 7, 5
    n = N_SP * m
    d = 3.0 + rng.random((lines, n))
    dl = -rng.random((lines, n))
    du = -rng.random((lines, n))
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    b = rng.normal(size=(lines, n))
    x_ref = np.stack(
        [
            np.linalg.solve(
                np.diag(d[i]) + np.diag(du[i, :-1], 1) + np.diag(dl[i, 1:], -1),
                b[i],
            )
            for i in range(lines)
        ]
    )
    mesh = Mesh(np.array(jax.devices()[:N_SP]), ("sp",))

    def chunk(a):
        return jnp.asarray(np.moveaxis(a.reshape(lines, N_SP, m), 1, 0))

    def local(dl_, d_, du_, b_):
        return spike_tridiag_solve(dl_[0], d_[0], du_[0], b_[0], "sp", N_SP)[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P("sp"),) * 4, out_specs=P("sp"),
        check_vma=False,
    )
    x = np.moveaxis(np.asarray(f(chunk(dl), chunk(d), chunk(du), chunk(b))), 0, 1)
    np.testing.assert_allclose(x.reshape(lines, n), x_ref, rtol=1e-12, atol=1e-12)


def _build(ncells, kinv_contrast=None, seed=0, ess=(0, 1, 1, 1, 1, 0)):
    fine = make_box_mesh(ncells, spacings=[1.0 / n for n in ncells])
    hier = build_geometric_hierarchy_from_fine(fine, 1)
    cfg = ProblemConfig(
        mesh="box", ncells=ncells, lengths=(1.0, 1.0, 1.0), refinements=0,
        dtype="float64", ess_attr=ess,
    )
    cfg.darcy_solver.name = "cg-schur"
    cfg.darcy_solver.relative_tolerance = 1e-9
    cfg.darcy_solver.max_iterations = 4000
    cfg.darcy_solver.local_schur_scaling = True
    kinv = None
    if kinv_contrast:
        rng = np.random.default_rng(seed)
        kinv = np.exp(
            rng.normal(size=(fine.num_cells, 3)) * np.log(kinv_contrast) / 4
        )
    solver = DarcySolver(hier, cfg, jnp.float64, kinv_ref=kinv)
    return hier, solver


@pytest.mark.parametrize("pad_case", [False, True])
def test_sharded_matches_unsharded(pad_case):
    # ny = 16 (divides 8) and ny = 14 (pad 2) both must agree with the
    # unsharded exact-Schur solve.
    ncells = (6, 14 if pad_case else 16, 5)
    hier, solver = _build(ncells, kinv_contrast=50.0)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    rng = np.random.default_rng(1)
    w = jnp.asarray(np.exp(rng.normal(size=(3, hier.levels[0].n_s)) * 0.5))
    q_ref, _, info = solver.solve_fwd(0, w)
    q_sp, iters, relres, conv = sp.solve_fwd(w)
    assert bool(np.asarray(info.converged).all())
    assert bool(np.asarray(conv).all())
    assert float(np.max(np.asarray(relres))) < 1e-8
    np.testing.assert_allclose(
        np.asarray(q_sp), np.asarray(q_ref), rtol=1e-6, atol=1e-9
    )


def test_sharded_flat_kinv_matches():
    hier, solver = _build((4, 16, 4))
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    rng = np.random.default_rng(2)
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.3))
    q_ref, _, _ = solver.solve_fwd(0, w)
    q_sp, _, relres, _ = sp.solve_fwd(w)
    assert float(np.max(np.asarray(relres))) < 1e-8
    np.testing.assert_allclose(np.asarray(q_sp), np.asarray(q_ref), rtol=1e-6)


def test_sharded_triton_route_in_interpreter(monkeypatch):
    """The route the GPU takes: every shard-local line solve (the x and z
    axes, the y axis under vmap, SPIKE's local solves) through the Triton
    kernel, here in Pallas' interpreter inside shard_map, agrees with the
    unsharded solve."""
    from parelagmc_tpu.ops import tridiag

    calls = []

    def kernel(*args, **kw):
        calls.append(args[-1].shape)
        return tridiag.thomas_triton(*args, block_lines=8, interpret=True)

    monkeypatch.setitem(tridiag._ROUTE_SOLVE, "triton", kernel)
    hier, solver = _build((4, 16, 4), kinv_contrast=50.0)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=4)
    rng = np.random.default_rng(5)
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.5))
    q_ref, _, _ = solver.solve_fwd(0, w)
    with tridiag.route_override("triton"):
        q_sp, _, relres, conv = sp.solve_fwd(w)
    assert len(calls) >= 4  # x, z, y spikes and y local solves
    assert bool(np.asarray(conv).all())
    assert float(np.max(np.asarray(relres))) < 1e-8
    np.testing.assert_allclose(np.asarray(q_sp), np.asarray(q_ref), rtol=1e-6)


def test_cut_axis_requires_essential_y():
    with pytest.raises(ValueError, match="y boundaries"):
        _build_and_shard_bad()


def _build_and_shard_bad():
    hier, solver = _build((4, 8, 4), ess=(1, 0, 1, 1, 1, 1))
    SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)


def test_direct_construction_zeroes_essential_rhs():
    """Direct construction (not from_darcy) with a raw rhs carrying
    nonzero entries on essential boundary faces must match the clean
    solve: the constructor zeroes them like DarcySolver does at setup
    (review r3)."""
    hier, solver = _build((4, 16, 4), kinv_contrast=10.0)
    mesh = hier.levels[0].mesh
    L = solver.levels[0]
    rhs_dirty = np.asarray(L.rhs, dtype=np.float64).copy()
    ess = np.asarray(L.ess)
    rhs_dirty[: L.n_u][ess] = 7.5  # garbage on essential faces
    sp = SpatialDarcy(
        mesh,
        solver.level_blocks(0),
        np.asarray(solver.config.ess_attr[:6]),
        rhs_dirty,
        np.asarray(L.obs_func, dtype=np.float64),
        solver.sbar_diag_np(0),
        n_sp=N_SP,
        dtype=jnp.float64,
        max_iters=4000,
        rtol=1e-9,
        ess=ess,
    )
    rng = np.random.default_rng(5)
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.3))
    q_ref, _, _ = solver.solve_fwd(0, w)
    q, _, rel, _ = sp.solve_fwd(w)
    assert float(np.max(np.asarray(rel))) < 1e-8
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_ref), rtol=1e-6)


def test_warm_start_and_pressure_return():
    """p0 = the exact solution must converge in 0 iterations and return the
    unsharded solver's physical pressure; the warm path is what
    DarcySolver.solve_fwd_warm routes MLMC pairs through."""
    hier, solver = _build((6, 16, 5), kinv_contrast=50.0)
    rng = np.random.default_rng(3)
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.5))
    q_ref, _, _, p_ref = solver.solve_fwd(0, w, return_pressure=True)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    q, it, rel, _, p = sp.solve_fwd(w, return_pressure=True)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_ref), atol=1e-7)
    q2, it2, _, _ = sp.solve_fwd(w, p0=p_ref)
    assert int(np.max(np.asarray(it2))) == 0
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q_ref), rtol=1e-9)


def test_sample_by_spatial_mesh():
    """Composed (dp, sp) = (2, 4) device mesh: batch sharded over dp, each
    realization's grid over sp - must match the unsharded solve. The CG
    while_loop continue-flag is reduced over dp too (a per-row exit
    deadlocks the SPMD collectives; spatial_darcy.any_active)."""
    hier, solver = _build((6, 16, 5), kinv_contrast=50.0)
    rng = np.random.default_rng(4)
    w = jnp.asarray(np.exp(rng.normal(size=(4, hier.levels[0].n_s)) * 0.5))
    q_ref, _, _ = solver.solve_fwd(0, w)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=4, n_dp=2)
    q, it, rel, _ = sp.solve_fwd(w)
    assert float(np.max(np.asarray(rel))) < 1e-8
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_ref), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of n_dp"):
        sp.solve_fwd(w[:3])


@pytest.mark.parametrize("ncells", [(8, 16, 6), (12, 64, 10), (12, 60, 10)])
def test_slab_coefmg_preconditioner(ncells):
    """cg-schur-coefmg routes the sharded solve through the slab-local
    per-sample Galerkin MG (restricted additive Schwarz) plus, when the
    slab ladder has a pair-aligned level, a replicated global coarse
    correction (two-level Schwarz). At high contrast it must (a) match
    the unsharded solve at tight rtol and (b) converge in a small
    multiple of the replicated coefMG's iterations - slab Jacobi degrades
    with the grid (measured 250 vs 48 iterations at (32,64,16)
    synthetic-SPE10 contrast; two-level lands at 49-51 vs 45-48) and its
    equal-residual QoI error blows up at scale. (8,16,6): m = 2,
    single-level slab ladder, no global graft; (12,64,10): m = 8,
    handoff level 1 with the global ladder engaged; (12,60,10): ny = 60
    pads to 64 (pad 4) - padded decoupled cells flowing through the slab
    ladder AND the gathered global coarse ladder (zero-dinv faces,
    guarded Jacobi diagonals)."""
    fine = make_box_mesh(ncells, spacings=[1.0 / n for n in ncells])
    hier = build_geometric_hierarchy_from_fine(fine, 1)
    cfg = ProblemConfig(
        mesh="box", ncells=ncells, lengths=(1.0, 1.0, 1.0), refinements=0,
        dtype="float64",
    )
    cfg.darcy_solver.name = "cg-schur-coefmg"
    cfg.darcy_solver.relative_tolerance = 1e-10
    cfg.darcy_solver.max_iterations = 4000
    rng = np.random.default_rng(7)
    kinv = np.exp(rng.normal(size=(fine.num_cells, 3)) * 3.0)  # ~1e5 contrast
    solver = DarcySolver(hier, cfg, jnp.float64, kinv_ref=kinv)
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    assert sp.precond == "coefmg"
    assert (sp.global_mg is not None) == (ncells != (8, 16, 6))
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.5))
    q_ref, _, info = solver.solve_fwd(0, w)
    q, it, rel, conv = sp.solve_fwd(w)
    assert bool(np.asarray(conv).all())
    assert float(np.max(np.asarray(rel))) < 1e-9
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_ref), rtol=1e-6)
    assert int(np.max(np.asarray(it))) < 4 * int(np.asarray(info.iterations))
    if ncells == (8, 16, 6):
        # Reduced-precision slab-MG state (coefmg_prec_dtype): same QoI,
        # essentially the same iterations (+4% measured at (12,64,10)).
        cfg.darcy_solver.coefmg_prec_dtype = "bfloat16"
        sp16 = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
        assert sp16.mg_prec_dtype == "bfloat16"
        q16, it16, _, _ = sp16.solve_fwd(w)
        np.testing.assert_allclose(np.asarray(q16), np.asarray(q_ref), rtol=1e-6)
        assert int(np.max(np.asarray(it16))) <= int(
            np.max(np.asarray(it)) * 1.3 + 2
        )


def test_spatial_with_auto_axis_order():
    """darcy_solver.spatial_shards composes with the axis_order="auto"
    device layout (the production SPE10 configuration): build_problem
    relabels the grid axes (largest-dim-minor) and permutes ess_attr, and
    the spatial solver cuts the RELABELED y axis - results must match the
    replicated solve on the same relabeled problem."""
    from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = (16, 32, 8)
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))

    def make(spatial):
        cfg = ProblemConfig(
            mesh="box", ncells=grid, lengths=lengths, refinements=0,
            dtype="float64", axis_order="auto", correlation_length=100.0,
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.relative_tolerance = 1e-8
        cfg.darcy_solver.max_iterations = 8000
        if spatial:
            cfg.darcy_solver.spatial_shards = N_SP
        return build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid))

    pr = make(False)
    assert pr.solver.hierarchy.levels[0].mesh.shape == (32, 16, 8)  # relabeled
    rng = np.random.default_rng(0)
    w = jnp.asarray(
        np.exp(rng.normal(size=(2, pr.solver.levels[0].n_s)) * 0.3)
    )
    q_ref = np.asarray(pr.solver.solve_fwd(0, w)[0])
    ps = make(True)
    q, _, info = ps.solver.solve_fwd(0, w)
    assert bool(np.asarray(info.converged).all())
    np.testing.assert_allclose(np.asarray(q), q_ref, rtol=1e-5)


def test_mlmc_with_spatial_sharding():
    """End-to-end MLMC through the config surface: darcy_solver
    .spatial_shards routes the finest level's solves (cold, warm-started
    pair, segmented restart) through SpatialDarcy; identical seed =>
    identical noise stream, so the estimate must match the unsharded run
    to solver tolerance."""
    from parelagmc_tpu.fem import build_geometric_hierarchy
    from parelagmc_tpu.mesh import make_box_mesh
    from parelagmc_tpu.samplers import SPDESampler
    from parelagmc_tpu.uq import MLMCManager
    from parelagmc_tpu.utils.timing import TimeManager

    def run(spatial):
        TimeManager.reset()
        mesh = make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0))
        hier = build_geometric_hierarchy(mesh, 2)
        cfg = ProblemConfig(
            refinements=1, mse=1e10, batch_size=8, initial_samples=8,
            seed=0, output_filename="",
        )
        cfg.darcy_solver.name = "cg-schur"
        cfg.darcy_solver.relative_tolerance = 1e-9
        cfg.darcy_solver.max_iterations = 2000
        if spatial:
            cfg.darcy_solver.spatial_shards = 4
            cfg.darcy_solver.spatial_sample_shards = 2
        sampler = SPDESampler(hier, cfg, jnp.float64)
        solver = DarcySolver(hier, cfg, jnp.float64)
        mgr = MLMCManager(solver, sampler, cfg)
        mgr.init_run([8, 8])
        return float(mgr.estimate), np.asarray(mgr.eY)

    est_ref, ey_ref = run(False)
    est_sp, ey_sp = run(True)
    np.testing.assert_allclose(est_sp, est_ref, rtol=1e-6)
    np.testing.assert_allclose(ey_sp, ey_ref, rtol=1e-5, atol=1e-9)


def test_spatial_adjoint_corrected_qoi():
    """adjoint=True on the sharded solve mirrors DarcySolver's
    config.adjoint_qoi (the second CG runs INSIDE the same shard_map):
    at loose rtol the corrected Q must land near the deep-converged truth
    (error ~ product of the primal/adjoint energy errors) where the plain
    loose solve carries the full contrast-amplified residual error. Also
    exercises the (p0, lam0) warm path and the 5-tuple return."""
    hier, solver = _build((6, 16, 5), kinv_contrast=200.0)
    rng = np.random.default_rng(5)
    w = jnp.asarray(np.exp(rng.normal(size=(2, hier.levels[0].n_s)) * 0.7))
    q_true = np.asarray(solver.solve_fwd(0, w)[0])  # replicated, rtol 1e-9

    solver.solver_cfg.relative_tolerance = 1e-3
    sp = SpatialDarcy.from_darcy(solver, 0, n_sp=N_SP)
    q_plain = np.asarray(sp.solve_fwd(w)[0])
    q_adj, it, rel, _, p, lam = sp.solve_fwd(
        w, adjoint=True, return_pressure=True
    )
    e_plain = np.max(np.abs(q_plain - q_true) / np.abs(q_true))
    e_adj = np.max(np.abs(np.asarray(q_adj) - q_true) / np.abs(q_true))
    # Measured: e_plain 3.4e-3, e_adj 9.1e-5 (38x) at rtol 1e-3 on this
    # fixed stream; the product bound is loose because the slab-Jacobi
    # preconditioner's energy error tracks the residual only to a factor.
    assert e_adj < 3e-4, (e_plain, e_adj)
    assert e_adj < 0.05 * e_plain, (e_plain, e_adj)
    # Warm restart from the converged (p, lam): both loops exit at once.
    q2, it2 = sp.solve_fwd(
        w, p0=p, lam0=lam, adjoint=True, return_pressure=True
    )[:2]
    assert int(np.max(np.asarray(it2))) == 0
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q_adj), rtol=1e-9)
    with pytest.raises(ValueError, match="lam0 requires"):
        sp.solve_fwd(w, lam0=lam)


def test_mlmc_spatial_adjoint_pair():
    """End-to-end MLMC pair with BOTH spatial sharding and adjoint_qoi:
    solve_fwd_pair solves the replicated coarse level with the adjoint,
    prolongates (p_c, lam_c), and the spatially-sharded fine level
    warm-starts both CGs inside shard_map. Same seed => the estimate must
    match the replicated adjoint run to solver tolerance."""
    from parelagmc_tpu.fem import build_geometric_hierarchy
    from parelagmc_tpu.samplers import SPDESampler
    from parelagmc_tpu.uq import MLMCManager
    from parelagmc_tpu.utils.timing import TimeManager

    def run(spatial):
        TimeManager.reset()
        mesh = make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0))
        hier = build_geometric_hierarchy(mesh, 2)
        cfg = ProblemConfig(
            refinements=1, mse=1e10, batch_size=8, initial_samples=8,
            seed=0, output_filename="",
        )
        cfg.darcy_solver.name = "cg-schur"
        cfg.darcy_solver.relative_tolerance = 1e-9
        cfg.darcy_solver.max_iterations = 2000
        cfg.darcy_solver.adjoint_qoi = True
        if spatial:
            cfg.darcy_solver.spatial_shards = 4
            cfg.darcy_solver.spatial_sample_shards = 2
        sampler = SPDESampler(hier, cfg, jnp.float64)
        solver = DarcySolver(hier, cfg, jnp.float64)
        assert solver.adjoint_pair_enabled(0)
        mgr = MLMCManager(solver, sampler, cfg)
        mgr.init_run([8, 8])
        return float(mgr.estimate), np.asarray(mgr.eY)

    est_ref, ey_ref = run(False)
    est_sp, ey_sp = run(True)
    np.testing.assert_allclose(est_sp, est_ref, rtol=1e-6)
    np.testing.assert_allclose(ey_sp, ey_ref, rtol=1e-5, atol=1e-9)
