"""Decompose the MLMC correction Y_l = Q_l - Q_{l+1} on an SPE10-class
problem into its two error sources, per sample:

    Y_field = Q_l(w_l)        - Q_l(P w_{l+1})   (sampler field mismatch,
                                                  same fine discretization)
    Y_disc  = Q_l(P w_{l+1})  - Q_{l+1}(w_{l+1}) (discretization + kinv
                                                  upscaling, same field)

with P the piecewise-constant prolongation of the coarse sample field. An
earlier hierarchy showed no multilevel variance decay (beta = -0.50); this
tool identifies which mechanism carries the variance so the fix targets
the right component (VERDICT round 2, item 1).

Runs on CPU float64 by default (scaled grid). Usage:
    python examples/spe10_rate_diagnostics.py --grid 16,56,16 --n 64
"""

import sys

sys.path.insert(0, ".")

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="16,56,16")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nlevels", type=int, default=3)
    ap.add_argument("--corlen", type=float, default=100.0)
    ap.add_argument("--variance", type=float, default=1.0)
    ap.add_argument("--solver", default="cg-schur-coefmg")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--cpu", action="store_true", default=True)
    ap.add_argument("--device", dest="cpu", action="store_false",
                    help="run on JAX's default device instead of CPU f64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--normalize", action="store_true",
                    help="exact marginal normalization of the SPDE field")
    ap.add_argument("--coarse-ops", default="galerkin",
                    choices=("galerkin", "rediscretize"))
    ap.add_argument("--flat-kinv", action="store_true",
                    help="replace the SPE10-like kinv_ref with 1 (isolates "
                    "the sampler/discretization effects from upscaling)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import dataclasses

    import jax.numpy as jnp

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    grid = tuple(int(x) for x in args.grid.split(","))
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = ProblemConfig(
        mesh="box",
        ncells=tuple(g // 2 ** (args.nlevels - 1) for g in grid),
        lengths=lengths,
        refinements=args.nlevels - 1,
        correlation_length=args.corlen,
        variance=args.variance,
        dtype="float64" if args.cpu else "float32",
        seed=args.seed,
    )
    cfg.darcy_solver.name = args.solver
    cfg.darcy_solver.relative_tolerance = args.rtol
    cfg.darcy_solver.max_iterations = 800
    cfg.normalize_marginals = args.normalize
    cfg.coarse_operators = args.coarse_ops
    kinv = None if args.flat_kinv else load_spe10_kinv(None, ncells=grid)
    prob = build_problem(cfg, kinv_ref=kinv)
    sampler, solver, hier = prob.sampler, prob.solver, prob.hierarchy

    key = jax.random.PRNGKey(args.seed)
    nl = cfg.nlevels
    print(f"# grid {grid}, levels {[hier.levels[l].mesh.shape for l in range(nl)]}")
    print(f"# dofs {[solver.num_dofs(l) for l in range(nl)]}")

    for level in range(nl - 1):
        qs_f, qs_c, qs_x = [], [], []
        corr_w = []
        bs = 16
        nb = -(-args.n // bs)
        for b in range(nb):
            k = jax.random.fold_in(jax.random.fold_in(key, level), b)
            xi = sampler.sample(level, k, bs)
            w_f = sampler.eval(level, xi)
            w_c = sampler.eval(level + 1, xi, xi_level=level)
            # fine-level field = prolongated coarse field
            w_x = jnp.take(w_c, hier.parent[level], axis=-1)
            q_f, _, info_f = solver.solve_fwd(level, w_f)
            q_c, _, info_c = solver.solve_fwd(level + 1, w_c)
            q_x, _, info_x = solver.solve_fwd(level, w_x)
            for acc, q in ((qs_f, q_f), (qs_c, q_c), (qs_x, q_x)):
                acc.append(np.asarray(q, dtype=np.float64))
            lf = np.log(np.asarray(w_f))
            lc = np.log(np.asarray(w_x))
            corr_w.append(
                np.mean(
                    [
                        np.corrcoef(lf[i], lc[i])[0, 1]
                        for i in range(lf.shape[0])
                    ]
                )
            )
            if b == 0:
                print(
                    f"# level {level}: iters f/c/x = "
                    f"{int(info_f.iterations)}/{int(info_c.iterations)}/{int(info_x.iterations)}"
                    f" converged {bool(info_f.converged.all())}/{bool(info_c.converged.all())}/{bool(info_x.converged.all())}"
                )
        q_f = np.concatenate(qs_f)
        q_c = np.concatenate(qs_c)
        q_x = np.concatenate(qs_x)
        y = q_f - q_c
        y_field = q_f - q_x
        y_disc = q_x - q_c
        print(f"== level pair ({level},{level + 1}), n={q_f.size} ==")
        print(f"  E[Q_f]={q_f.mean():.4g}  E[Q_c]={q_c.mean():.4g}  E[Q_x]={q_x.mean():.4g}")
        print(f"  Var[Q_f]={q_f.var():.4g}  Var[Q_c]={q_c.var():.4g}")
        print(f"  E[Y]={y.mean():.4g}      Var[Y]={y.var():.4g}      corr(Qf,Qc)={np.corrcoef(q_f, q_c)[0, 1]:.4f}")
        print(f"  E[Y_field]={y_field.mean():.4g}  Var[Y_field]={y_field.var():.4g}  (sampler field mismatch)")
        print(f"  E[Y_disc]={y_disc.mean():.4g}   Var[Y_disc]={y_disc.var():.4g}   (discretization+upscaling)")
        print(f"  mean corr(log w_f, log P w_c) = {np.mean(corr_w):.4f}")


if __name__ == "__main__":
    main()
