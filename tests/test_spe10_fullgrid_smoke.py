"""Full-grid SPE10 smoke: operator-build + compile-only memory probe + one
single-batch convergence check, without a GPU (reference CTest
philosophy, examples/CMakeLists.txt:59-120).

The CI anchor (tests/test_spe10_anchor.py) pins only a 16x32x8 scaled
run, so an operator-build or memory regression at the real 60x220x85 grid
would surface only at the next GPU run (chip_smoke.py). This test builds
the production problem at full grid on the CPU backend, compiles (without
executing) the memory-critical level-0 fine warm-start program via the
jit_hoisted compile-only probe and
bounds its temp footprint, and runs ONE small batch at level 1 asserting
converged_fraction == 1.0 with production-anchor-class iteration counts.

Slow-marked (tests/slow_tests.txt): host operator build + one 563k-dof
f32 solve batch, a few minutes on CPU.
"""

import numpy as np
import pytest  # noqa: F401  (slow mark applied via slow_tests.txt)


def test_spe10_fullgrid_build_compile_converge():
    import jax

    from examples.common import parse_config
    from examples.spe10_mlmc import full_grid_solver_defaults
    from parelagmc_tpu.ops.jit_utils import jit_hoisted
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    cfg = parse_config(
        ["--refinements", "2", "--dtype", "float32"],
        mesh="spe10",
        correlation_length=100.0,
        normalize_marginals=True,
        axis_order="auto",
    )
    full_grid_solver_defaults(cfg, [])
    kinv = load_spe10_kinv(None, ncells=(60, 220, 85))
    prob = build_problem(cfg, kinv_ref=kinv)
    sampler, solver = prob.sampler, prob.solver

    # Full-grid operator shapes (catches hierarchy/operator-build drift).
    assert solver.num_dofs(0) > 4_000_000
    # (z coarsens 85 -> 42 -> 21 by merging
    # the trailing layer into the last coarse cell.)
    assert [sampler.sample_size(l) for l in range(3)] == [
        1_122_000, 138_600, 17_325
    ]
    assert [solver.num_dofs(l) for l in range(3)] == [
        4_525_000, 563_580, 71_595
    ]

    # Compile-only probe of the level-0 fine warm-start program at the
    # production batch 8 - the memory-critical program of the split pair
    # step. CPU-backend temp size differs from a GPU's (layout/fusion),
    # but an operator blowup (extra materialized fields, lost remat) moves
    # it by integer factors; chip_smoke.py prints the card's figure.
    batch = 8
    key = jax.random.PRNGKey(0)
    n_sf = solver.levels[0].n_s
    n_pc = solver.levels[1].n_s
    ex_sf = jax.ShapeDtypeStruct((batch, n_sf), prob.dtype)
    ex_pc = jax.ShapeDtypeStruct((batch, n_pc), prob.dtype)

    def fine_warm(s_f, p_c):
        q, _, info, p = solver.solve_fwd_warm(0, s_f, p_c, return_pressure=True)
        return q, info.converged, info.iterations

    f = jit_hoisted(fine_warm, ex_sf, ex_pc)
    ma = f.memory_analysis()  # compiles; raises on any lowering regression
    temp_gb = ma.temp_size_in_bytes / 1e9
    assert temp_gb < 24.0, f"level-0 warm-pair temp {temp_gb:.1f} GB"
    assert ma.temp_size_in_bytes > 0

    # One executed batch at level 1 (563k dofs): the solves the estimator
    # actually runs, conv canary per CLAUDE.md validity rules. Production
    # anchors put level-1 mean iterations ~49; the ceiling is
    # max_iterations (75) - a level pinned at the ceiling means the
    # conv-flag gate or the solver regressed.
    xi = sampler.sample(1, jax.random.fold_in(key, 1), 2)
    w = sampler.eval(1, xi)
    _, _, info = solver.solve_fwd(1, w)
    conv = np.asarray(info.converged)
    iters = float(np.asarray(info.iterations))
    assert conv.all(), f"level-1 converged_fraction {conv.mean():.2f}"
    assert iters < cfg.darcy_solver.max_iterations, iters
