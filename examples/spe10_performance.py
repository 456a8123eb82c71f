"""SPE10-scale MLMC performance harness with a JSON report.

Reference analog: examples/SPE10/SPE10_PDESampler_Performance.cpp:165-185 -
time nsamples of (Sample + Eval [+ Darcy forward]) per level and print the
per-level dofs / iterations / sec-per-sample table. This harness also runs
the MLMC coupled pair step per level (the estimator's real hot loop) and
writes everything to a JSON file (default spe10_performance.json).

Timing discipline: distinct PRNG keys per measured call and a host fetch of
every result, so no in-flight work is left unmeasured.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from examples.common import parse_config
from parelagmc_tpu.ops.jit_utils import jit_hoisted
from parelagmc_tpu.physics.spe10 import load_spe10_kinv
from parelagmc_tpu.problems import build_problem


def _struct_vcycle_batch_selfcheck(solver, tol=1e-4):
    """Batch-consistency canary for the structured coefMG (the history note
    in ops/coef_multigrid_structured.py): sample 0 of a batch-2
    multi-output V-cycle program must match the batch-1 run bit-for-bit up
    to fusion reassociation. A backend fusion miscompile once made it O(1)
    wrong - silently destroying solver convergence while every op passed
    in isolation."""
    from parelagmc_tpu.ops import coef_multigrid_structured as cms

    L = solver.levels[0]
    if not isinstance(getattr(L, "coef_mg", None), cms.StructCoefMG):
        print("-- selfcheck skipped (no structured coefMG at level 0)")
        return
    mg = L.coef_mg
    d = len(mg.levels[0].shape)
    shape0 = mg.levels[0].shape
    rng = np.random.default_rng(0)
    n_c = int(np.prod(shape0))
    w2 = jnp.asarray(
        np.exp(rng.normal(size=(2, n_c)) * 0.7), jnp.float32
    )
    p2 = jnp.asarray(rng.normal(size=(2, n_c)), jnp.float32)

    def parts(ww, pp):
        dw = L.m_diag(ww)
        d0 = jnp.where(dw > 0, 1.0 / jnp.where(dw == 0, 1.0, dw), 0.0)
        st = cms.struct_mg_setup(mg, d0)
        bg = pp.reshape(pp.shape[:-1] + tuple(shape0[::-1]))
        rc = cms._restrict_cells(bg, mg.levels[1], d) if len(mg.levels) > 1 else bg
        return (
            cms.struct_v_cycle(mg, st, pp),
            cms.struct_s_apply(mg, st, pp),
            cms._v_cycle_grid(mg, st, rc, 2, 1) if len(mg.levels) > 1 else rc,
        )

    o1 = jax.jit(parts)(w2[:1], p2[:1])
    o2 = jax.jit(parts)(w2, p2)
    for name, a, b in zip(("v_cycle", "s_apply", "coarse_cycle"), o1, o2):
        a, b = np.asarray(a)[0], np.asarray(b)[0]
        dd = float(np.abs(a - b).max() / (np.abs(a).max() or 1.0))
        if dd > tol:
            raise RuntimeError(
                f"struct coefMG batch-consistency selfcheck FAILED on "
                f"'{name}': batch-2 sample 0 deviates rel {dd:.3e} from the "
                f"batch-1 run - a fusion miscompile of the V-cycle program "
                f"(ops/coef_multigrid_structured.py guard comment)"
            )
        print(f"-- selfcheck {name}: batch1-vs-batch2[0] rel diff {dd:.1e} ok")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    perm_file = None
    if "--perm-file" in argv:
        i = argv.index("--perm-file")
        perm_file = argv[i + 1]
        del argv[i : i + 2]
    out_file = "spe10_performance.json"
    if "--out" in argv:
        i = argv.index("--out")
        out_file = argv[i + 1]
        del argv[i : i + 2]
    selfcheck = "--selfcheck" in argv
    if selfcheck:
        argv.remove("--selfcheck")
    # Coarse-level batch clamp: level 2 dominates total MLMC walltime at
    # the optimal N_l allocation, so its batch cap is a first-order knob -
    # --batch-clamp 1024 to probe past 512.
    batch_clamp = 512
    if "--batch-clamp" in argv:
        i = argv.index("--batch-clamp")
        batch_clamp = int(argv[i + 1])
        del argv[i : i + 2]
    # Per-sample Galerkin MG: converges SPE10 level-0 solves to rtol 1e-4
    # in ~31 iterations (vs 480+ iterations stuck at ~5e-4 for the static
    # kinv MG with local scaling) - the per-sample hierarchy is decisive
    # at 1e6 contrast.
    darcy_solver = "cg-schur-coefmg"
    if "--darcy-solver" in argv:
        i = argv.index("--darcy-solver")
        darcy_solver = argv[i + 1]
        del argv[i : i + 2]
    cfg = parse_config(
        argv,
        mesh="spe10",
        refinements=2,
        correlation_length=100.0,
        initial_samples=64,
        batch_size=64,
        # Match the SPE10 MLMC driver's field model (exact marginal
        # normalization; --raw-marginals to disable).
        normalize_marginals=True,
        # Largest-dim-minor device layout (y=220 becomes the minor axis;
        # config.axis_order, to be re-measured on the GPU). --axis-order
        # none to disable.
        axis_order="auto",
    )
    cfg.darcy_solver.name = darcy_solver
    # Bounded executions: 80 Krylov iterations per program, and
    # unconverged solves continue across up to `segments` bounded
    # executions (warm-restarted). Local
    # sqrt(w)-scaled MG: the global geometric-mean scale leaves CG nearly
    # unpreconditioned on SPE10-contrast lognormal fields.
    # rtol 1e-5: a 1e-4 residual leaves the flux QoI ~6x wrong at SPE10
    # contrast (see CLAUDE.md r3 note); 1e-5 is within 0.06% of deep
    # convergence and f32 reaches it with segmented restarts. (With
    # --solver-opt adjoint_qoi=true the QoI error is the PRODUCT of the
    # primal and adjoint residuals, so looser rtols become valid - these
    # harness defaults yield to explicit --solver-opt overrides.)
    user_opts = {
        argv[i + 1].partition("=")[0]
        for i, tok in enumerate(argv)
        if tok == "--solver-opt"
    }
    if "max_iterations" not in user_opts:
        cfg.darcy_solver.max_iterations = 80
    if "relative_tolerance" not in user_opts:
        cfg.darcy_solver.relative_tolerance = 1e-5
    if "local_schur_scaling" not in user_opts:
        cfg.darcy_solver.local_schur_scaling = True
    # Production tuning (mirrors examples/spe10_mlmc.py; measured r3):
    # cheb3 lo=0.10 smoothing cuts level-0 Schur-CG iterations 171 -> 109
    # and bf16 preconditioner state cuts per-iteration cost 48.7 -> 35.5 ms.
    # The converged_fraction column below is the validity canary for any
    # capture with these on.
    if "coefmg_cheby_order" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_order = 3
    if "coefmg_cheby_lo" not in user_opts:
        cfg.darcy_solver.coefmg_cheby_lo = 0.10
    if "coefmg_prec_dtype" not in user_opts:
        cfg.darcy_solver.coefmg_prec_dtype = "bfloat16"
    segments = 6
    kinv = load_spe10_kinv(perm_file, ncells=(60, 220, 85))
    prob = build_problem(cfg, kinv_ref=kinv)
    sampler, solver = prob.sampler, prob.solver

    if selfcheck:
        _struct_vcycle_batch_selfcheck(solver)
    key = jax.random.PRNGKey(cfg.seed)
    dt_bytes = 4 if cfg.dtype == "float32" else 8

    def level_batch(level):
        """Cap the per-level batch so the coupled pair step fits in device
        memory.

        The finest SPE10 level holds ~4.5M Darcy dofs; the warm-started
        pair solve keeps O(tens) of live field vectors per sample (Krylov
        basis + MG workspace + coupled coarse system). Real MLMC allocates
        few samples to the finest level anyway (N_l ~ Var/cost), so a
        small fine-level batch matches the estimator's own schedule;
        COARSE levels instead want the largest batch that fits - with
        positive variance-decay rates the optimal N_l puts most samples
        there, so their throughput dominates total MLMC walltime. Budget:
        12G / (40 vectors * dofs * dtype), capped at 512; the finest level
        keeps the production batch 8 (ROADMAP queue 1 item 4 re-tunes
        it)."""
        if solver.num_dofs(level) > 2_000_000:
            return 8
        per_sample = 40 * solver.num_dofs(level) * dt_bytes
        cap = max(8, int(12e9 / per_sample))
        return min(batch_clamp, 1 << (cap.bit_length() - 1))

    def timed(step, label, batch, prejitted=False, max_reps=None):
        reps = max(1, cfg.initial_samples // batch)
        if max_reps is not None:
            reps = min(reps, max_reps)
        else:
            reps = max(reps, 4)
        f = step if prejitted else jit_hoisted(step, key)
        # Distinct key for the compile/warmup call.
        t0 = time.perf_counter()
        np.asarray(f(jax.random.fold_in(key, 987654))[0])
        compile_s = time.perf_counter() - t0
        # Best of 3 rounds with distinct keys: host load and warm-up
        # transients add positive noise (cf. bench.py).
        dt, outs = np.inf, None
        for r in range(3):
            t0 = time.perf_counter()
            cur = [f(jax.random.fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
            _ = [np.asarray(o[0]) for o in cur]
            d = time.perf_counter() - t0
            if d < dt:
                dt, outs = d, cur
        n = reps * batch
        iters = float(np.mean([np.asarray(o[-1]) for o in outs]))
        # Steps returning (value, converged, iterations) also report the
        # converged fraction: an unconverged capture is NOT evidence (the
        # 2026-08-18 miscompile made level-0 silently max out its budget).
        conv = (
            float(np.mean([np.asarray(o[1], dtype=np.float64) for o in outs]))
            if len(outs[0]) == 3
            else None
        )
        conv_txt = "" if conv is None else f" conv {conv * 100:.0f}%"
        print(
            f"  {label:28s} {dt / n * 1e3:10.3f} ms/sample "
            f"{n / dt:10.1f} samples/s  iters {iters:.0f}{conv_txt} "
            f"(compile {compile_s:.1f}s)"
        )
        if conv is not None and conv < 1.0:
            print(f"  !! {label}: only {conv * 100:.0f}% of samples "
                  f"converged - treat this capture as INVALID")
        out = {
            "sec_per_sample": dt / n,
            "samples_per_sec": n / dt,
            "mean_iterations": iters,
            "compile_sec": compile_s,
        }
        if conv is not None:
            out["converged_fraction"] = conv
        return out

    evidence = {
        "config": {
            "mesh": "spe10 60x220x85 (20x10x2 ft)",
            "nlevels": cfg.nlevels,
            "batch": cfg.batch_size,
            "dtype": cfg.dtype,
            "correlation_length_ft": cfg.correlation_length,
            "darcy_solver": cfg.darcy_solver.name,
            "darcy_max_iterations": cfg.darcy_solver.max_iterations,
            "perm": "spe_perm.dat" if perm_file else "synthetic fallback",
        },
        "levels": [],
    }
    print(f"-- SPE10 performance: {cfg.nlevels} levels, batch {cfg.batch_size}")
    for level in range(cfg.nlevels):
        batch = level_batch(level)
        row = {
            "level": level,
            "stoch_dofs": int(sampler.sample_size(level)),
            "darcy_dofs": int(solver.num_dofs(level)),
            "darcy_nnz": int(solver.nnz(level)),
            "batch": batch,
        }
        print(
            f"level {level}: sampler dofs {row['stoch_dofs']}, "
            f"darcy dofs {row['darcy_dofs']}, nnz {row['darcy_nnz']}, "
            f"batch {batch}"
        )

        # Sampler-only timing uses the FULL batch: it has no Darcy memory
        # pressure, and at batch 8 fixed per-call costs dominate.
        se_batch = cfg.batch_size

        def sample_eval(k, level=level, batch=se_batch):
            s = sampler.eval(level, sampler.sample(level, k, batch))
            # Per-sample reduction: fetch O(batch) scalars, not the O(n_s)
            # field - the host transfer would otherwise dominate timing.
            return jnp.mean(s, axis=-1), jnp.zeros(())

        row["sample_eval"] = timed(sample_eval, "Sample+Eval", se_batch)

        if level < cfg.nlevels - 1:
            # The coupled pair runs as TWO bounded device programs (coarse
            # solve, then warm-started fine solve), like the managers'
            # split_pair_programs. The intermediate (s_f, p_c) stays on
            # device.

            def pair_coarse(k, level=level, batch=batch):
                xi = sampler.sample(level, k, batch)
                s_f = sampler.eval(level, xi)
                s_c = sampler.eval(level + 1, xi, xi_level=level)
                qc, _, i_c, p_c = solver.solve_fwd(
                    level + 1, s_c, return_pressure=True
                )
                return s_f, p_c, qc, i_c.iterations, i_c.converged

            def pair_fine(s_f, p_c, level=level):
                q, _, i_f, p = solver.solve_fwd_warm(
                    level, s_f, p_c, return_pressure=True
                )
                return q, i_f.iterations, i_f.converged, p

            def pair_cont(s_f, p_prev, level=level):
                q, _, i_f, p = solver.solve_fwd_x0(
                    level, s_f, p_prev, return_pressure=True
                )
                return q, i_f.iterations, i_f.converged, p

            f1 = jit_hoisted(pair_coarse, key)
            ex = f1(key)
            f2 = jit_hoisted(pair_fine, ex[0], ex[1])
            ex2 = f2(ex[0], ex[1])
            f3 = jit_hoisted(pair_cont, ex[0], ex2[3]) if segments > 1 else None

            def pair(k):
                s_f, p_c, qc, it_c, conv_c = f1(k)
                q, it_f, conv, p = f2(s_f, p_c)
                iters = it_f + it_c
                for _ in range(segments - 1):
                    if bool(np.asarray(conv).all()):
                        break
                    q, it_f, conv, p = f3(s_f, p)
                    iters = iters + it_f
                # converged_fraction canary must cover BOTH solves: an
                # unconverged cold coarse solve corrupts Y=q-qc just as
                # surely as an unconverged fine one (review r3).
                return q - qc, conv & conv_c, iters

            # Level-0 pair solves are minutes each (segmented ~500-iteration
            # MG-CG at 4.5M dofs); 2 measured reps bound the harness runtime.
            row["mlmc_pair"] = timed(pair, "MLMC pair (coupled+Darcy)", batch,
                                     prejitted=True,
                                     max_reps=2 if level == 0 else None)
        else:

            def single(k, level=level, batch=batch):
                s = sampler.eval(level, sampler.sample(level, k, batch))
                q, _, info = solver.solve_fwd(level, s)
                return q, info.converged, info.iterations

            row["mlmc_pair"] = timed(single, "coarsest Q (Darcy)", batch)
        evidence["levels"].append(row)

    with open(out_file, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"wrote {out_file}")
    return evidence


if __name__ == "__main__":
    main()
