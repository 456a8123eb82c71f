import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy
from parelagmc_tpu.mesh import make_box_mesh
from parelagmc_tpu.physics import DarcySolver

DT = jnp.float64


def golden_setup(nlevels=2, base=(4, 4, 4), qoi="eff_perm"):
    mesh = make_box_mesh(base, lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, nlevels)
    cfg = ProblemConfig(refinements=nlevels - 1, qoi=qoi)
    cfg.darcy_solver.relative_tolerance = 1e-10
    return hier, DarcySolver(hier, cfg, DT)


def dense_saddle_solve(hier, solver, level, w):
    """Oracle: dense solve of the constrained saddle system."""
    lvl = hier.levels[level]
    ess = np.asarray(solver.levels[level].ess)
    M = lvl.mass_csr(w).toarray()
    B = lvl.b_csr().toarray()
    n_u, n_s = lvl.n_u, lvl.n_s
    A = np.zeros((n_u + n_s, n_u + n_s))
    A[:n_u, :n_u] = M
    A[:n_u, n_u:] = B.T
    A[n_u:, :n_u] = B
    # Eliminate essential rows/cols to identity.
    for i in np.nonzero(ess)[0]:
        A[i, :] = 0.0
        A[:, i] = 0.0
        A[i, i] = 1.0
    b = np.asarray(solver.levels[level].rhs, dtype=np.float64)
    return np.linalg.solve(A, b)


def test_deterministic_unit_coefficient_qoi():
    # k = 1: analytic effective permeability through the cube of side 2 with
    # p=1 on top, p=0 on bottom is Q = area * dp/L = 4 * 1/2 = 2, and RT0/P0
    # on tensor grids reproduces it exactly. This is the reference's
    # DarcyDeterministicTest analog (examples/CMakeLists.txt:62-66).
    hier, solver = golden_setup(nlevels=3, base=(2, 2, 2))
    for level in range(3):
        w = jnp.ones((1, hier.levels[level].n_s), dtype=DT)
        Q, cost, info = solver.solve_fwd(level, w)
        np.testing.assert_allclose(np.asarray(Q), 2.0, rtol=1e-8)
        assert bool(info.converged.all())
    # Dof counts at the golden sizes (base 4^3 + 2 refinements).
    hier2, solver2 = golden_setup(nlevels=3, base=(4, 4, 4))
    assert [solver2.num_dofs(l) for l in range(3)] == [17152, 2240, 304]


def test_solution_matches_dense_oracle():
    hier, solver = golden_setup(nlevels=1, base=(3, 3, 3))
    rng = np.random.default_rng(0)
    w = np.exp(rng.normal(size=(2, hier.levels[0].n_s)))
    Q, cost, info, p = solver.solve_fwd(0, jnp.asarray(w), return_pressure=True)
    assert bool(info.converged.all())
    for b in range(2):
        ref = dense_saddle_solve(hier, solver, 0, w[b])
        n_u = hier.levels[0].n_u
        np.testing.assert_allclose(np.asarray(p[b]), -ref[n_u:], atol=1e-7)
        q_ref = float(np.asarray(solver.levels[0].obs_func) @ ref)
        np.testing.assert_allclose(float(Q[b]), q_ref, atol=1e-8)


def test_preconditioner_iteration_count():
    # The tensor-Schur block preconditioner must keep MINRES iterations
    # bounded for lognormal coefficients.
    hier, solver = golden_setup(nlevels=1, base=(8, 8, 8))
    rng = np.random.default_rng(1)
    w = np.exp(rng.normal(size=(4, hier.levels[0].n_s)))
    Q, cost, info = solver.solve_fwd(0, jnp.asarray(w))
    assert bool(info.converged.all())
    assert int(info.iterations) < 250


def test_p_int_qoi():
    # Volume-integral-of-pressure QoI: k=1 gives p(z) = z/2 on [0,2]^3
    # => int p = 8 * 1 = ... cell-centered values sum_i p_i V_i = exact
    # because p is linear and cell values are exact at centers.
    hier, solver = golden_setup(nlevels=1, base=(4, 4, 4), qoi="p_int")
    w = jnp.ones((1, hier.levels[0].n_s), dtype=DT)
    Q, cost, info = solver.solve_fwd(0, w)
    # int_{[0,2]^3} z/2 = 8 * mean(z/2) = 8 * 0.5 = 4.
    np.testing.assert_allclose(np.asarray(Q), 4.0, rtol=1e-8)


def test_local_avg_p_qoi():
    hier, solver = golden_setup(nlevels=1, base=(4, 4, 4), qoi="local_avg_p")
    w = jnp.ones((1, hier.levels[0].n_s), dtype=DT)
    Q, cost, info = solver.solve_fwd(0, w)
    # Marked cells near (0.5, 0.5, 0.5) with eps=0.1: single cell containing
    # the point has center (0.25k..) - mesh 4^3 on [0,2]: h=0.5, centers at
    # 0.25,0.75,...; point (0.5,0.5,0.5) is a corner between cells; eps=0.1
    # doesn't reach any center (distance 0.25) so Q = 0... use eps=0.3.
    cfg = ProblemConfig(refinements=0, qoi="local_avg_p", qoi_eps=0.3)
    cfg.darcy_solver.relative_tolerance = 1e-10
    solver2 = DarcySolver(hier, cfg, DT)
    Q2, _, _ = solver2.solve_fwd(0, w)
    # 8 cells with centers at 0.25/0.75 in each axis, all within 0.3 of 0.5.
    # p at center z: z/2 -> values 0.125 and 0.375, mean 0.25; V = 0.125.
    np.testing.assert_allclose(np.asarray(Q2), 8 * 0.125 * 0.25, rtol=1e-8)


def test_batched_levels_consistency():
    # Q on coarser levels approaches fine Q (discretization effect is zero
    # here because flux is exact on all levels for k=1).
    hier, solver = golden_setup(nlevels=3, base=(2, 2, 2))
    qs = []
    for level in range(3):
        w = jnp.ones((1, hier.levels[level].n_s), dtype=DT)
        Q, _, _ = solver.solve_fwd(level, w)
        qs.append(float(Q[0]))
    np.testing.assert_allclose(qs, 2.0, rtol=1e-8)


def test_solve_fwd_pair_matches_separate_solves():
    # Warm-started pair solve (reference MLMC_Manager.cpp:150-156 +
    # PDESampler.cpp:451-516) is an iteration-count optimization only: the
    # converged results must match the separate cold solves.
    import jax

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.fem import build_geometric_hierarchy
    from parelagmc_tpu.mesh import make_box_mesh
    from parelagmc_tpu.physics import DarcySolver
    from parelagmc_tpu.samplers import SPDESampler

    hier = build_geometric_hierarchy(make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2)
    cfg = ProblemConfig(refinements=1)
    cfg.darcy_solver.relative_tolerance = 1e-10
    sampler = SPDESampler(hier, cfg, jnp.float64)
    solver = DarcySolver(hier, cfg, jnp.float64)
    xi = sampler.sample(0, jax.random.PRNGKey(4), 4)
    s_f = sampler.eval(0, xi)
    s_c = sampler.eval(1, xi, xi_level=0)
    q_cold, _, _ = solver.solve_fwd(0, s_f)
    qc_cold, _, _ = solver.solve_fwd(1, s_c)
    q, qc, info_f, info_c = solver.solve_fwd_pair(0, s_f, s_c)
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_cold), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(qc), np.asarray(qc_cold), rtol=1e-7)
    # The warm start's value is accuracy at a FIXED iteration budget (the
    # f32 production mode): with the budget capped, the warm-started pair
    # must be much closer to the converged QoI than the cold solve.
    cfg.darcy_solver.relative_tolerance = 0.0
    cfg.darcy_solver.max_iterations = 15
    solver2 = DarcySolver(hier, cfg, jnp.float64)
    q15_cold, _, _ = solver2.solve_fwd(0, s_f)
    q15_warm, _, _, _ = solver2.solve_fwd_pair(0, s_f, s_c)
    err_cold = np.abs(np.asarray(q15_cold) - np.asarray(q_cold)).mean()
    err_warm = np.abs(np.asarray(q15_warm) - np.asarray(q_cold)).mean()
    # Strictly better on this small config; the gap widens on the golden
    # 16^3 config (measured: 6.5e-2 warm vs 2.3 cold at 40 iterations).
    assert err_warm < 0.85 * err_cold, (err_warm, err_cold)


def test_coefmg_solver_matches_exact_schur():
    """cg-schur-coefmg (per-sample Galerkin MG) matches the exact-Schur
    solver's QoIs to solver tolerance on the golden config, in fewer
    iterations on lognormal coefficients."""
    import jax

    from parelagmc_tpu.samplers import SPDESampler

    hier = build_geometric_hierarchy(make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2)
    results = {}
    for name in ("cg-schur", "cg-schur-coefmg"):
        cfg = ProblemConfig(refinements=1, batch_size=4)
        cfg.darcy_solver.name = name
        cfg.darcy_solver.relative_tolerance = 1e-10
        cfg.darcy_solver.max_iterations = 500
        cfg.darcy_solver.coarse_dense_cutoff = 30
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        xi = sampler.sample(0, jax.random.PRNGKey(2), 4)
        s = sampler.eval(0, xi)
        q, _, info = solver.solve_fwd(0, s)
        assert bool(np.asarray(info.converged).all()), name
        results[name] = (np.asarray(q), int(info.iterations))
    np.testing.assert_allclose(
        results["cg-schur-coefmg"][0], results["cg-schur"][0], rtol=1e-7
    )


def test_coefmg_bf16_prec_state_matches():
    """coefmg_prec_dtype="bfloat16" (reduced-precision V-cycle tables and
    residual math; the CG stays in the solve dtype) must converge to the
    same QoI with essentially the same iteration count - a preconditioner
    only needs ~1e-2 relative quality. Measured at synthetic-SPE10
    contrast (32,64,16), f32 solve: 48/74 iterations at rtol 1e-5/1e-6
    for BOTH f32 and bf16 states; the bf16 state halves the
    bandwidth-bound V-cycle's bytes."""
    import jax

    from parelagmc_tpu.samplers import SPDESampler

    hier = build_geometric_hierarchy(
        make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2
    )
    results = {}
    for pd in ("", "bfloat16"):
        cfg = ProblemConfig(refinements=1, batch_size=4)
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.relative_tolerance = 1e-8
        cfg.darcy_solver.max_iterations = 500
        cfg.darcy_solver.coarse_dense_cutoff = 30
        cfg.darcy_solver.coefmg_prec_dtype = pd
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        xi = sampler.sample(0, jax.random.PRNGKey(2), 4)
        s = sampler.eval(0, xi)
        q, _, info = solver.solve_fwd(0, s)
        assert bool(np.asarray(info.converged).all()), pd
        results[pd] = (np.asarray(q), int(info.iterations))
    np.testing.assert_allclose(
        results["bfloat16"][0], results[""][0], rtol=1e-6
    )
    assert results["bfloat16"][1] <= int(results[""][1] * 1.3) + 2


def test_coefmg_smoother_knobs_reach_preconditioner():
    """coefmg_sweeps / coefmg_omega / coefmg_cheby_order change only the
    preconditioner (the smoother-tuning surface): every
    variant converges to the same QoI; a deliberately weakened smoother
    (one damped sweep) needs at least as many iterations as V(2,2)."""
    import jax

    from parelagmc_tpu.samplers import SPDESampler

    hier = build_geometric_hierarchy(
        make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2
    )
    results = {}
    for label, over in (
        ("prod", {}),
        ("weak", {"coefmg_sweeps": 1, "coefmg_omega": 0.4}),
        ("cheb", {"coefmg_cheby_order": 3}),
    ):
        cfg = ProblemConfig(refinements=1, batch_size=4)
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.relative_tolerance = 1e-10
        cfg.darcy_solver.max_iterations = 500
        cfg.darcy_solver.coarse_dense_cutoff = 30
        for k, v in over.items():
            setattr(cfg.darcy_solver, k, v)
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        xi = sampler.sample(0, jax.random.PRNGKey(2), 4)
        s = sampler.eval(0, xi)
        q, _, info = solver.solve_fwd(0, s)
        assert bool(np.asarray(info.converged).all()), label
        results[label] = (np.asarray(q), int(info.iterations))
    np.testing.assert_allclose(results["weak"][0], results["prod"][0], rtol=1e-7)
    np.testing.assert_allclose(results["cheb"][0], results["prod"][0], rtol=1e-7)
    assert results["weak"][1] >= results["prod"][1]


def test_cg_schur_coefmg_structured_matches_gather():
    """solve_fwd with the structured (slicing) coefMG preconditioner
    produces the same QoI as with the generic gather tables - same
    preconditioner up to float reassociation, so same converged solve."""
    import dataclasses

    from parelagmc_tpu.problems import build_problem

    rng = np.random.default_rng(5)
    kinv = np.exp(rng.normal(size=(6 * 10 * 7,)) * 2.0)
    qois = []
    iters = []
    for impl in ("auto", "gather"):
        cfg = ProblemConfig(
            mesh="box", ncells=(6, 10, 7), lengths=(1.2, 2.0, 0.7),
            refinements=0, batch_size=2, dtype="float64",
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.relative_tolerance = 1e-10
        cfg.darcy_solver.coefmg_impl = impl
        prob = build_problem(cfg, kinv_ref=kinv)
        from parelagmc_tpu.ops.coef_multigrid_structured import StructCoefMG

        is_struct = isinstance(prob.solver.levels[0].coef_mg, StructCoefMG)
        assert is_struct == (impl == "auto")
        w = jnp.asarray(
            np.exp(rng.standard_normal((2, 6 * 10 * 7)) * 0.0 + 1.0)
        )  # fixed field so both runs see identical input
        q, _, info = prob.solver.solve_fwd(0, w)
        qois.append(np.asarray(q))
        iters.append(int(info.iterations))
        assert bool(np.all(np.asarray(info.converged)))
    np.testing.assert_allclose(qois[0], qois[1], rtol=1e-8)
    assert abs(iters[0] - iters[1]) <= 2


def test_apply_b_stencil_matches_gather():
    """The structured slicing-form B/B^T (DarcyLevel.b_struct) equals the
    gather-incidence form on every level, including essential masking and
    non-dyadic coarse shapes."""
    from parelagmc_tpu.fem.hierarchy import build_geometric_hierarchy_from_fine

    mesh = make_box_mesh((6, 10, 7), lengths=(1.2, 2.0, 0.7))
    hier = build_geometric_hierarchy_from_fine(mesh, 2)
    cfg = ProblemConfig(mesh="box", ncells=(6, 10, 7), refinements=0,
                        dtype="float64")
    s = DarcySolver(hier, cfg, jnp.float64)
    for lev in range(2):
        L = s.levels[lev]
        assert L.b_struct is not None
        rng = np.random.default_rng(lev)
        u = jnp.asarray(rng.normal(size=(3, L.n_u)))
        p = jnp.asarray(rng.normal(size=(3, L.n_s)))
        Lg = L._replace(b_struct=None)
        np.testing.assert_allclose(
            np.asarray(s._apply_B(L, u)), np.asarray(s._apply_B(Lg, u)),
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(s._apply_Bt(L, p)), np.asarray(s._apply_Bt(Lg, p)),
            atol=1e-12,
        )


def test_adjoint_qoi_composes_with_barrier_aware_mg():
    # Goal-oriented QoI correction (config.adjoint_qoi): with the
    # barrier-aware coefMG (cheb3 + zy lines + harmonic coarse faces) the
    # remaining QoI error is the PRODUCT of the primal and adjoint
    # residuals. Measured at the (30,110,42) half-scale synthetic SPE10
    # (CPU f64): rtol 1e-4 plain err 2.5e-1 -> adjoint err 7.0e-6.
    # Without the barrier-aware preconditioner the correction is nearly
    # useless (energy errors stay O(1) until the barrier modes resolve,
    # measured gain 1.4x) - the two features compose.
    import numpy as np

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = (8, 28, 11)
    kinv = load_spe10_kinv(None, ncells=grid)
    s = None
    out = {}
    for rtol, adjoint in ((1e-12, False), (1e-4, False), (1e-4, True)):
        cfg = ProblemConfig(
            mesh="box", ncells=grid, lengths=(1200.0, 2200.0, 170.0),
            refinements=0, batch_size=2, correlation_length=100.0,
            normalize_marginals=True, dtype="float64",
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.max_iterations = 3000
        cfg.darcy_solver.relative_tolerance = rtol
        cfg.darcy_solver.adjoint_qoi = adjoint
        cfg.darcy_solver.coefmg_cheby_order = 3
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
        cfg.darcy_solver.coefmg_line_axes = "zy"
        cfg.darcy_solver.coefmg_coarsen = "harmonic"
        prob = build_problem(cfg, kinv_ref=kinv)
        if s is None:
            xi = prob.sampler.sample(0, jax.random.PRNGKey(0), 2)
            s = np.asarray(prob.sampler.eval(0, xi))
        q, _, info = prob.solver.solve_fwd(0, jnp.asarray(s))
        out[(rtol, adjoint)] = np.asarray(q)
    truth = out[(1e-12, False)]
    e_plain = np.max(np.abs(out[(1e-4, False)] - truth) / np.abs(truth))
    e_adj = np.max(np.abs(out[(1e-4, True)] - truth) / np.abs(truth))
    assert e_adj < 1e-3, (e_plain, e_adj)
    assert e_adj < 0.05 * e_plain, (e_plain, e_adj)


def test_adjoint_qoi_pair_correction_variable():
    # MLMC correction variable Y = Q_f - Q_c through solve_fwd_pair with
    # config.adjoint_qoi: the coarse adjoint warm-starts the fine adjoint
    # (same P0 parent-take prolongation as the pressure). Measured on the
    # (16,56,22) synthetic-SPE10 pair (CPU f64, PRNGKey(0), batch 2):
    # rtol 1e-4 adjoint Y error 2.0e-3 at 7 fine iterations, vs 1.8-5.5
    # (O(1)!) plain at the same rtol and still 0.21-0.25 at plain 1e-6 -
    # the pair difference amplifies the per-level QoI noise, so rate
    # evidence (alpha/beta) is garbage without the correction.
    import numpy as np

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = (8, 28, 11)
    kinv = load_spe10_kinv(None, ncells=(16, 56, 22))

    def build(adjoint, rtol):
        cfg = ProblemConfig(
            mesh="box", ncells=grid, lengths=(1200.0, 2200.0, 170.0),
            refinements=1, batch_size=2, correlation_length=100.0,
            normalize_marginals=True, dtype="float64",
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.max_iterations = 3000
        cfg.darcy_solver.relative_tolerance = rtol
        cfg.darcy_solver.adjoint_qoi = adjoint
        cfg.darcy_solver.coefmg_cheby_order = 3
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
        cfg.darcy_solver.coefmg_line_axes = "zy"
        cfg.darcy_solver.coefmg_coarsen = "harmonic"
        return build_problem(cfg, kinv_ref=kinv)

    p0 = build(False, 1e-12)
    xi = p0.sampler.sample(0, jax.random.PRNGKey(0), 2)
    sf = jnp.asarray(np.asarray(p0.sampler.eval(0, xi)))
    sc = jnp.asarray(np.asarray(p0.sampler.eval(1, xi, xi_level=0)))
    qT, qcT, _, _ = p0.solver.solve_fwd_pair(0, sf, sc)
    y_true = np.asarray(qT) - np.asarray(qcT)

    errs = {}
    for adjoint in (True, False):
        prob = build(adjoint, 1e-4)
        q, qc, info_f, info_c = prob.solver.solve_fwd_pair(0, sf, sc)
        assert bool(np.asarray(info_f.converged).all())
        assert bool(np.asarray(info_c.converged).all())
        y = np.asarray(q) - np.asarray(qc)
        errs[adjoint] = np.max(np.abs(y - y_true) / np.abs(y_true))
    assert errs[True] < 2e-2, errs
    assert errs[True] < 0.05 * errs[False], errs


def test_adjoint_stacked_matches_sequential():
    """config.adjoint_stacked: the primal+adjoint pair solved as ONE
    stacked PCG (rhs axis -2, vmapped operator/prec closures) must
    reproduce the sequential two-solve path - same corrected QoI, same
    returned pressure/adjoint iterates (both converge to the same
    per-row true-residual criterion), honest converged flags, and
    iterations reported as operator applications (2x the stacked loop's
    trip count, comparable to the sequential it_p + it_a)."""
    import numpy as np

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = (8, 28, 11)
    kinv = load_spe10_kinv(None, ncells=(16, 56, 22))

    def build(stacked):
        cfg = ProblemConfig(
            mesh="box", ncells=grid, lengths=(1200.0, 2200.0, 170.0),
            refinements=1, batch_size=2, correlation_length=100.0,
            normalize_marginals=True, dtype="float64",
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.max_iterations = 3000
        cfg.darcy_solver.relative_tolerance = 1e-10
        cfg.darcy_solver.adjoint_qoi = True
        cfg.darcy_solver.adjoint_stacked = stacked
        cfg.darcy_solver.coefmg_cheby_order = 3
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
        return build_problem(cfg, kinv_ref=kinv)

    seq = build(False)
    stk = build(True)
    xi = seq.sampler.sample(0, jax.random.PRNGKey(3), 2)
    s = jnp.asarray(np.asarray(seq.sampler.eval(0, xi)))

    q_a, _, info_a, p_a, lam_a = seq.solver.solve_fwd(
        0, s, return_pressure=True, return_adjoint=True
    )
    q_b, _, info_b, p_b, lam_b = stk.solver.solve_fwd(
        0, s, return_pressure=True, return_adjoint=True
    )
    assert bool(np.asarray(info_a.converged).all())
    assert bool(np.asarray(info_b.converged).all())
    np.testing.assert_allclose(np.asarray(q_b), np.asarray(q_a), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(p_b), np.asarray(p_a), rtol=0, atol=1e-7 * float(np.max(np.abs(np.asarray(p_a)))))
    np.testing.assert_allclose(np.asarray(lam_b), np.asarray(lam_a), rtol=0, atol=1e-7 * float(np.max(np.abs(np.asarray(lam_a)))))
    # Operator-application accounting: within 2x of the sequential count
    # (stacked pays max(it_p, it_a) trips at two applies each).
    it_seq = int(np.asarray(info_a.iterations))
    it_stk = int(np.asarray(info_b.iterations))
    assert it_stk <= 2 * it_seq and it_stk >= it_seq // 2, (it_seq, it_stk)

    # Warm-start threading (the MLMC pair path): restarting the stacked
    # solve from its own converged (p, lam) must exit (nearly) immediately
    # at the same QoI.
    q_w, _, info_w, p_w, lam_w = stk.solver.solve_fwd_x0(
        0, s, p_b, lam0=lam_b, return_pressure=True, return_adjoint=True
    )
    assert int(np.asarray(info_w.iterations)) <= 4
    np.testing.assert_allclose(np.asarray(q_w), np.asarray(q_b), rtol=1e-8)

    # Pair path (coarse adjoint warm-starts the fine member).
    sc = jnp.asarray(np.asarray(seq.sampler.eval(1, xi, xi_level=0)))
    qf_a, qc_a, if_a, ic_a = seq.solver.solve_fwd_pair(0, s, sc)
    qf_b, qc_b, if_b, ic_b = stk.solver.solve_fwd_pair(0, s, sc)
    assert bool(np.asarray(if_b.converged).all())
    assert bool(np.asarray(ic_b.converged).all())
    np.testing.assert_allclose(np.asarray(qf_b), np.asarray(qf_a), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(qc_b), np.asarray(qc_a), rtol=1e-8)


def test_meanfield_x0_warm_start():
    """config.meanfield_x0: cold solves start from the cached one-per-level
    mean-field (w == 1) iterate - same converged QoI (to Krylov tolerance),
    strictly fewer iterations on a lognormal batch, and composition with
    the adjoint-corrected QoI (lam warm-started from the mean-field
    adjoint). Measured on this problem (CPU f64): level-1 38 -> 24 cold
    iterations."""
    import numpy as np

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = (4, 14, 6)
    kinv = load_spe10_kinv(None, ncells=(16, 56, 24))

    def build(meanfield, adjoint=False):
        cfg = ProblemConfig(
            mesh="box", ncells=grid, lengths=(1200.0, 2200.0, 170.0),
            refinements=2, batch_size=4, correlation_length=100.0,
            normalize_marginals=True, dtype="float64",
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        cfg.darcy_solver.max_iterations = 3000
        cfg.darcy_solver.relative_tolerance = 1e-8
        cfg.darcy_solver.coefmg_cheby_order = 3
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
        cfg.darcy_solver.meanfield_x0 = meanfield
        cfg.darcy_solver.adjoint_qoi = adjoint
        cfg.darcy_solver.adjoint_stacked = adjoint
        return build_problem(cfg, kinv_ref=kinv)

    cold = build(False)
    warm = build(True)
    xi = cold.sampler.sample(0, jax.random.PRNGKey(5), 4)
    s = jnp.asarray(np.asarray(cold.sampler.eval(1, xi, xi_level=0)))

    q_c, _, info_c = cold.solver.solve_fwd(1, s)
    q_w, _, info_w = warm.solver.solve_fwd(1, s)
    assert bool(np.asarray(info_w.converged).all())
    np.testing.assert_allclose(np.asarray(q_w), np.asarray(q_c), rtol=1e-5)
    it_c = int(np.asarray(info_c.iterations))
    it_w = int(np.asarray(info_w.iterations))
    assert it_w < it_c, (it_c, it_w)
    # The mean-field iterate is cached: a second solve must not re-run
    # the setup solve (cache populated exactly once per level).
    assert set(warm.solver._mf_cache) == {1}
    warm.solver.solve_fwd(1, s)
    assert set(warm.solver._mf_cache) == {1}

    # Composes with the stacked adjoint-corrected QoI.
    adj = build(True, adjoint=True)
    adj_ref = build(False, adjoint=True)
    q_a, _, info_a = adj.solver.solve_fwd(1, s)
    q_r, _, info_r = adj_ref.solver.solve_fwd(1, s)
    assert bool(np.asarray(info_a.converged).all())
    np.testing.assert_allclose(np.asarray(q_a), np.asarray(q_r), rtol=1e-5)
    assert int(np.asarray(info_a.iterations)) < int(np.asarray(info_r.iterations))


def test_meanfield_x0_first_call_under_jit():
    """Regression: the lazy mean-field cache fill must work when the FIRST
    solve_fwd call is itself being traced (the managers jit their step
    functions, so the cache is usually populated at trace time). Before the
    jax.ensure_compile_time_eval() escape in _meanfield_start, the host-side
    convergence check hit a TracerArrayConversionError."""
    import numpy as np

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    cfg = ProblemConfig(
        mesh="box", ncells=(4, 14, 6), lengths=(1200.0, 2200.0, 170.0),
        refinements=1, batch_size=2, correlation_length=100.0,
        normalize_marginals=True, dtype="float64",
    )
    cfg.darcy_solver.name = "cg-schur-coefmg"
    cfg.darcy_solver.max_iterations = 3000
    cfg.darcy_solver.relative_tolerance = 1e-8
    cfg.darcy_solver.meanfield_x0 = True
    cfg.darcy_solver.adjoint_qoi = True
    prob = build_problem(
        cfg, kinv_ref=load_spe10_kinv(None, ncells=(8, 28, 12))
    )
    xi = prob.sampler.sample(0, jax.random.PRNGKey(3), 2)
    s = jnp.asarray(np.asarray(prob.sampler.eval(0, xi)))
    # Fresh solver: first solve happens inside jit tracing.
    q_j, _, info_j = jax.jit(lambda w: prob.solver.solve_fwd(0, w))(s)
    assert bool(np.asarray(info_j.converged).all())
    ref = build_problem(
        ProblemConfig(
            mesh="box", ncells=(4, 14, 6), lengths=(1200.0, 2200.0, 170.0),
            refinements=1, batch_size=2, correlation_length=100.0,
            normalize_marginals=True, dtype="float64",
        ),
        kinv_ref=load_spe10_kinv(None, ncells=(8, 28, 12)),
    )
    ref.solver.solver_cfg.max_iterations = 3000
    ref.solver.solver_cfg.relative_tolerance = 1e-8
    q_r, _, _ = ref.solver.solve_fwd(0, s)
    # Adjoint-corrected vs plain QoI at finite Krylov tolerance: agreement
    # to ~1e-4 relative is the expected band at this contrast.
    np.testing.assert_allclose(np.asarray(q_j), np.asarray(q_r), rtol=1e-3)
    # Regression (measured at SPE10 scale 2026-08-20): the cache entry
    # filled during ONE jit trace must be reusable from a DIFFERENT later
    # trace - indexing the setup solution outside the compile-time-eval
    # scope cached an ambient-trace tracer and the second program died
    # with UnexpectedTracerError. Trace a fresh program per level that
    # reuses the now-populated cache.
    for lvl in (0, 1):
        xi_l = prob.sampler.sample(lvl, jax.random.PRNGKey(7), 2)
        s_l = jnp.asarray(np.asarray(prob.sampler.eval(lvl, xi_l)))
        q2, _, info2 = jax.jit(
            lambda w, lvl=lvl: prob.solver.solve_fwd(lvl, w)
        )(s_l)
        assert bool(np.asarray(info2.converged).all())
        assert np.isfinite(np.asarray(q2)).all()
