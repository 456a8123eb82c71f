"""MLMC on the SPE10 benchmark: Darcy flow through the SPE10 permeability
field perturbed by a random log-normal multiplier sampled with the SPDE
sampler (reference analog: examples/SPE10/SPE10_MLMC.cpp; permeability
loading SPE10_MLMC.cpp:165-171 - here owned by physics/spe10.py, with a
synthetic fallback when spe_perm.dat is absent).

Defaults are scaled down (--refinements 1, large corlen) so the driver is
runnable on one device out of the box; pass --refinements 2 and
--perm-file data/spe_perm.dat for the full configuration.
"""

import sys

sys.path.insert(0, ".")

import dataclasses

import numpy as np

from examples.common import parse_config
from parelagmc_tpu.physics.spe10 import load_spe10_kinv
from parelagmc_tpu.problems import build_problem
from parelagmc_tpu.uq import MLMCManager
from parelagmc_tpu.utils.timing import TimeManager


def full_grid_solver_defaults(cfg, argv):
    """Full-grid (60x220x85) production solver defaults, each yielding to
    an explicit --solver-opt override already applied by parse_config.

    Bounded executions: split each pair step into two device programs,
    cap Krylov iterations per execution and continue unconverged solves
    across bounded segments (config.split_pair_programs, solve_segments;
    whether the GPU needs them is ROADMAP design item 2).

    Tolerance: at SPE10's ~1e6 contrast the flux QoI's sensitivity to the
    Schur residual is ~1e5 x the TRUE relative residual and varies
    strongly per realization (CLAUDE.md r3 REVISED note - plain rtol 1e-6
    still leaves worst-sample Q errors ~3%), so production enables the
    adjoint-corrected QoI: measured full scale against a CONVERGED
    adjoint@1e-6 truth (examples/spe10_adjoint_check.py, batch 8),
    adjoint@rtol 1e-4 costs about the same as plain@1e-6 and lands 10x
    closer on Q (0.33% vs 3.2% worst sample) - the QoI error is the
    PRODUCT of the primal and adjoint residuals, so the loose rtol stays
    QoI-valid. chip_smoke.py's spe10 phase re-checks the level-0 Q
    against a deep solve on the card.
    """
    cfg.split_pair_programs = True
    cfg.solve_segments = 4
    cfg.darcy_solver.name = "cg-schur-coefmg"
    user_opts = {
        argv[i + 1].partition("=")[0]
        for i, tok in enumerate(argv)
        if tok == "--solver-opt"
    }
    if "adjoint_qoi" not in user_opts:
        cfg.darcy_solver.adjoint_qoi = True
    if "relative_tolerance" not in user_opts:
        cfg.darcy_solver.relative_tolerance = (
            1e-4 if cfg.darcy_solver.adjoint_qoi else 1e-6
        )
    if "max_iterations" not in user_opts:
        # Per device program (with adjoint_qoi each program holds TWO
        # Krylov solves, so halve the budget; segments cover stragglers;
        # must also cover the COLD coarse member of a pair - ~110
        # iterations at level 1, rtol 1e-6).
        cfg.darcy_solver.max_iterations = (
            75 if cfg.darcy_solver.adjoint_qoi else 150
        )
    # Full-scale level-0 tuning: order-3 Chebyshev smoothing with lo=0.10
    # cuts Schur-CG iterations 171 -> 109 at rtol 1e-7 vs the Jacobi
    # V(2,2) cycle; bfloat16 preconditioner state halves the V-cycle's
    # bytes with no iteration penalty. Both were timed on the accelerator
    # this code was first written for; ROADMAP queue 1 item 8 re-decides
    # them on the GPU. Any re-capture should watch the solver-iterations
    # row of show_me() (an unconverged level inflates it to
    # max_iterations*segments).
    if "coefmg_cheby_order" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_order = 3
    if "coefmg_cheby_lo" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
    if "coefmg_prec_dtype" not in user_opts:
        cfg.darcy_solver.coefmg_prec_dtype = "bfloat16"
    # adjoint_stacked stays OFF: steady-state traces on the accelerator
    # this code was first written for showed the stacked trip losing at
    # levels 0-1 (it doubles the rhs work) - to be re-measured on the GPU
    # (ROADMAP queue 1 item 8). Estimator-neutral either way; opt in per
    # run with --solver-opt adjoint_stacked=true.
    if "meanfield_x0" not in user_opts:
        # Warm-start cold solves from the cached mean-field solution.
        # Measured at full scale: coarsest-Q iterations 43.75 -> 23 (the
        # level carrying ~97% of the optimal-N_l samples) and level-0 pair
        # iterations 51.5 -> 24.5. Estimator-neutral: counter-aligned
        # paired Y on the production stream agrees to rms 0.033 (0.07% of
        # Var[Y_0], corr 0.9997), Q to 7.7e-4.
        cfg.darcy_solver.meanfield_x0 = True
    # Memory-sized finest batch, throughput-sized coarse batches (the
    # full grid's finest level is 4.5M Darcy dofs at any nlevels). These
    # were sized for a 16 GB device; ROADMAP queue 1 item 4 re-tunes them
    # for the H100's 80 GB. The optimal N_l allocation is coarse-heavy, so
    # the coarse-level batches dominate total walltime.
    cfg.batch_size_per_level = [8, 128] + [512] * (cfg.nlevels - 2)
    return cfg


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    adaptive = "--adaptive" in argv
    if adaptive:
        argv.remove("--adaptive")
    perm_file = None
    if "--perm-file" in argv:
        i = argv.index("--perm-file")
        perm_file = argv[i + 1]
        del argv[i: i + 2]
    grid = None  # optional scaled-down grid "nx,ny,nz" (synthetic perm only)
    if "--grid" in argv:
        i = argv.index("--grid")
        grid = tuple(int(x) for x in argv[i + 1].split(","))
        del argv[i: i + 2]
    cfg = parse_config(
        argv,
        mesh="spe10",
        refinements=1,
        correlation_length=100.0,  # feet; SPE10 domain is 1200x2200x170 ft
        mse=-1.0,  # auto-MSE from the bias estimate
        initial_samples=32,
        batch_size=32,
        # Exact per-cell marginal normalization of the SPDE field (override
        # with --raw-marginals for reference statistical parity): with the
        # 100 ft correlation length, the coarse SPE10 levels under-resolve
        # the field and the raw per-level marginal-variance mismatch
        # destroys the MLMC variance decay (measured beta = -0.5 in round
        # 2; see examples/spe10_rate_diagnostics.py).
        normalize_marginals=True,
        # Largest-dim-minor device layout (y=220 becomes the minor axis;
        # config.axis_order, to be re-measured on the GPU). --axis-order
        # none to disable.
        axis_order="auto",
    )
    if grid is not None:
        # Scaled-down run on a grid with the SPE10 domain extents.
        import dataclasses

        from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING

        lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
        f = 2 ** cfg.refinements
        cfg = dataclasses.replace(
            cfg, mesh="box", ncells=tuple(g // f for g in grid), lengths=lengths
        )
        kinv = load_spe10_kinv(None, ncells=grid)
    else:
        # Full 60x220x85 grid; odd z-counts coarsen by merging the trailing
        # layer into the last coarse cell (non-dyadic derefinement).
        kinv = load_spe10_kinv(perm_file, ncells=(60, 220, 85))
        full_grid_solver_defaults(cfg, argv)
    prob = build_problem(cfg, kinv_ref=kinv)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    if adaptive:
        # The reference's headline mode (MLMC_Manager::Run,
        # MLMC_Manager.cpp:181-214): initial samples estimate the rates,
        # then compute_nsamples_mse drives per-level N_l from the measured
        # V_l / C_l until ml_estimator_variance <= ratio * eps2 (with
        # --mse -1, eps2 auto-set from the rate-extrapolated bias each
        # round, MLMC_Manager.cpp:357-358).
        est = mgr.run()
        print(
            f"-- adaptive: estimate {est:.6g}, target eps2 {mgr.eps2:.6g}, "
            f"actual MSE {mgr.actual_mse:.6g} "
            f"(sampling var {mgr.ml_estimator_variance:.6g} <= "
            f"{mgr.ratio:.2f}*eps2 = {mgr.ratio * mgr.eps2:.6g}), "
            f"N_l = {list(mgr.level_nsamples)}"
        )
    else:
        mgr.init_run([cfg.initial_samples] * cfg.nlevels)
    print(mgr.show_me())
    TimeManager.print_table()
    mgr.close()
    return mgr


if __name__ == "__main__":
    main()
