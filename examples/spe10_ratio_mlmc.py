"""Bayesian ratio MLMC on SPE10 subsurface flow (north-star configs[4]).

Reference analog: examples/RatioEstimator_MLMC_Manager.cpp driving
ML_BayesRatio(_Splitting)_Manager (src/ML_BayesRatio_Manager.hpp:314-573)
with the SPDE prior + Darcy likelihood on the SPE10 benchmark - the
reference's capstone capability at full scale.

Posterior setup: three "well" pressure observations at mid-depth along
the long (y) axis of the 1200x2200x170 ft domain, local-average
functionals of radius 30 ft (config.bayes_num_obs/_obs_coords/_eps,
reference BayesianInverseProblem.cpp:44-104), synthetic data y = G(u_ref)
+ N(0, noise) from one prior draw. Estimators: E[R]/E[Z] ratio and the
E[R/Z] splitting variant (--splitting).

Full-grid runs (default) inherit the production solver defaults from
examples/spe10_mlmc.py (adjoint-corrected QoI, cheb3/bf16 coefMG,
meanfield warm starts, split Z/R stream programs). --grid
nx,ny,nz runs a scaled box with the SPE10 extents (synthetic perm), used
by the CI anchor test.

Writes spe10_ratio_mlmc.json: posterior estimate, Z/R moment
dashboards, adaptive N_l, per-level solver convergence canary.

Usage (on the GPU, from the checkout root):
    python examples/spe10_ratio_mlmc.py --refinements 2 --samples 64
    python examples/spe10_ratio_mlmc.py --refinements 2 --splitting ...
"""

import sys

sys.path.insert(0, ".")

import dataclasses
import json

import numpy as np

from examples.common import parse_config
from examples.spe10_mlmc import full_grid_solver_defaults
from parelagmc_tpu.physics.spe10 import load_spe10_kinv
from parelagmc_tpu.problems import build_problem
from parelagmc_tpu.uq import BayesianInverseProblem, BayesRatioManager
from parelagmc_tpu.utils.timing import TimeManager

# Mid-depth "wells" along the long axis (ft); local-average radius 30 ft
# covers a 3x6x30-cell box at the 20x10x2 ft SPE10 spacing.
OBS_COORDS = (300.0, 550.0, 85.0, 600.0, 1100.0, 85.0, 900.0, 1650.0, 85.0)
OBS_EPS = 30.0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    splitting = "--splitting" in argv
    if splitting:
        argv.remove("--splitting")
    adaptive = "--adaptive" in argv
    if adaptive:
        argv.remove("--adaptive")
    perm_file = None
    if "--perm-file" in argv:
        i = argv.index("--perm-file")
        perm_file = argv[i + 1]
        del argv[i: i + 2]
    grid = None
    if "--grid" in argv:
        i = argv.index("--grid")
        grid = tuple(int(x) for x in argv[i + 1].split(","))
        del argv[i: i + 2]
    out_json = "spe10_ratio_mlmc.json"
    if "--out" in argv:
        i = argv.index("--out")
        out_json = argv[i + 1]
        del argv[i: i + 2]
    cfg = parse_config(
        argv,
        mesh="spe10",
        refinements=1,
        correlation_length=100.0,
        mse=1e10,  # fixed-N evidence mode by default; --adaptive targets MSE
        initial_samples=32,
        batch_size=32,
        normalize_marginals=True,
        axis_order="auto",
    )
    # Local-average radius: 30 ft on the real grid; scaled grids have
    # coarser cells, so widen to keep at least one cell center in range.
    from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING

    lengths_ft = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    gcells = grid if grid is not None else SPE10_NCELLS
    eps = max(OBS_EPS, 0.75 * max(L / n for L, n in zip(lengths_ft, gcells)))
    cfg = dataclasses.replace(
        cfg,
        bayes_num_obs=3,
        bayes_obs_coords=OBS_COORDS,
        bayes_eps=eps,
        bayes_generate_ref_data=True,
        bayes_ref_data_file="",  # synthetic per run (deterministic seed)
    )
    if grid is not None:
        from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING

        lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
        f = 2 ** cfg.refinements
        cfg = dataclasses.replace(
            cfg, mesh="box", ncells=tuple(g // f for g in grid), lengths=lengths
        )
        kinv = load_spe10_kinv(None, ncells=grid)
    else:
        kinv = load_spe10_kinv(perm_file, ncells=(60, 220, 85))
        full_grid_solver_defaults(cfg, argv)
    prob = build_problem(cfg, kinv_ref=kinv)
    cfg = prob.config  # axis permutation applied (incl. obs coords)
    bip = BayesianInverseProblem(prob.solver, prob.sampler, cfg, prob.dtype)
    bip.generate_observational_data()
    print(f"-- observational data y = {np.asarray(bip.G_obs)}")

    # Solver convergence canary on the exact solves the Z/R streams run
    # (the ratio steps do not surface SolveInfo; an unconverged level is
    # NOT a result).
    import jax

    canary = []
    for level in range(cfg.nlevels):
        xi = prob.sampler.sample(level, jax.random.PRNGKey(99 + level), 8)
        w = prob.sampler.eval(level, xi)
        _, _, info, _ = prob.solver.solve_fwd(level, w, return_pressure=True)
        canary.append({
            "level": level,
            "converged_fraction": float(np.mean(np.asarray(info.converged))),
            "mean_iterations": float(np.mean(np.asarray(info.iterations))),
        })
        print(f"-- canary L{level}: conv "
              f"{canary[-1]['converged_fraction'] * 100:.0f}% "
              f"iters {canary[-1]['mean_iterations']:.0f}")

    mgr = BayesRatioManager(bip, cfg, splitting=splitting)
    if adaptive:
        est = mgr.run()
    else:
        mgr.init_run([cfg.initial_samples] * cfg.nlevels)
        est = mgr.estimate
    kind = "ML_BayesRatio_Splitting" if splitting else "ML_BayesRatio"
    print(f"FINAL {kind}_Manager ERRORS")
    dash = mgr.show_me()
    print(dash)
    TimeManager.print_table()

    evidence = {
        "config": {
            "grid": list(grid) if grid else [60, 220, 85],
            "nlevels": cfg.nlevels,
            "estimator": "splitting" if splitting else "ratio",
            "adaptive": adaptive,
            "obs_coords_ft": list(OBS_COORDS),
            "obs_eps_ft": eps,
            "noise": cfg.bayes_noise,
            "perm": "spe_perm.dat" if perm_file else "synthetic fallback",
            "solver": cfg.darcy_solver.name,
        },
        "posterior_estimate": float(est),
        "obs_data": [float(x) for x in np.asarray(bip.G_obs)],
        "N_l": [int(n) for n in mgr.level_nsamples],
        "C_l_sec_per_sample": [float(c) for c in mgr.cost],
        "solver_canary": canary,
        "show_me": dash,
    }
    with open(out_json, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"written: {out_json}")
    mgr.close()
    return est, mgr


if __name__ == "__main__":
    main()
