"""Full-scale SPE10 validity + cost check for the adjoint-corrected QoI
(config.adjoint_qoi): per-sample MLMC correction variable Y = Q_0 - Q_1
against a deep-converged truth, for

  plain   : primal-only solves at --plain-rtol   (production 1e-5)
  adjoint : primal+adjoint solves at --adjoint-rtol (default 1e-4)

At SPE10's ~1e6 contrast the flux QoI error is ~1e5 x the TRUE relative
residual (CLAUDE.md r3 revised note), so plain rtol 1e-4 is QoI-invalid;
the adjoint correction makes the QoI error the PRODUCT of the primal and
adjoint energy errors, which is what lets loose rtols produce tight QoIs
(measured on the (16,56,22) synthetic pair: rtol 1e-4 Y error 2e-3 with
the correction vs O(1) without, tests/test_darcy.py). This harness proves
the same composition at FULL scale in f32 on the device, where recurrence
drift is in play, and prices it: if
adjoint@loose beats plain@1e-5 in wall per converged pair, it becomes the
production SPE10 configuration.

Reference analog: none - the reference brute-forces solver tolerance in
f64 (examples/SPE10/SPE10_MLMC.cpp uses fixed tight tolerances).

Usage (on the GPU, from the checkout root):
    python examples/spe10_adjoint_check.py [--batch 8] [--seed 7]
        [--adjoint-rtol 1e-4] [--plain-rtol 1e-5] [--truth-rtol 1e-7]
        [--grid 60,220,85] [--platform cpu] [--out spe10_adjoint_check.json]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    argv = sys.argv
    get = lambda k, d, c=str: c(argv[argv.index(k) + 1]) if k in argv else d

    import jax

    if get("--platform", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import dataclasses

    import jax.numpy as jnp

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.ops.jit_utils import jit_hoisted
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    batch = get("--batch", 8, int)
    seed = get("--seed", 7, int)
    grid = tuple(int(t) for t in get("--grid", "60,220,85").split(","))
    cpu = get("--platform", "") == "cpu"
    rtols = {
        "plain": get("--plain-rtol", 1e-5, float),
        "adjoint": get("--adjoint-rtol", 1e-4, float),
        "truth": get("--truth-rtol", 1e-7, float),
    }
    out_file = get("--out", "spe10_adjoint_check.json")
    # Extra DarcySolverConfig fields applied to the ADJOINT variant only
    # (truth and plain legs stay at the anchored configuration), e.g.
    #   --solver-opt adjoint_stacked=true --solver-opt meanfield_x0=true
    # so a candidate solver lever is priced against the unchanged truth.
    solver_opts = [
        argv[i + 1] for i, tok in enumerate(argv) if tok == "--solver-opt"
    ]

    def apply_opts(scfg):
        from examples.common import apply_solver_opt

        for kv in solver_opts:
            apply_solver_opt(scfg, kv)

    def build(adjoint, rtol, extra_opts=False):
        if grid == (60, 220, 85):
            mesh_kw = dict(mesh="spe10", refinements=2)
        else:
            # Scaled synthetic-SPE10 box: 2 levels, fine = 2 x ncells
            # (tests/test_darcy.py pair-test geometry).
            assert all(g % 2 == 0 for g in grid), "--grid dims must be even"
            mesh_kw = dict(
                mesh="box",
                ncells=(grid[0] // 2, grid[1] // 2, grid[2] // 2),
                lengths=(1200.0, 2200.0, 170.0),
                refinements=1,
            )
        cfg = ProblemConfig(
            batch_size=batch,
            correlation_length=100.0,
            normalize_marginals=True,
            dtype="float64" if cpu else "float32",
            axis_order="auto",
            seed=seed,
            **mesh_kw,
        )
        cfg.darcy_solver.name = "cg-schur-coefmg"
        # Duration guard (CLAUDE.md): bounded executions, host continuation.
        # With adjoint_qoi each program holds TWO Krylov solves, so the
        # per-program budget defaults to half the plain-path 80.
        cfg.darcy_solver.max_iterations = get("--max-iters", 40, int)
        cfg.darcy_solver.relative_tolerance = rtol
        cfg.darcy_solver.local_schur_scaling = True
        cfg.darcy_solver.adjoint_qoi = adjoint
        if extra_opts:
            apply_opts(cfg.darcy_solver)
        return build_problem(cfg, kinv_ref=load_spe10_kinv(None, ncells=grid))

    # One problem instance provides the sample fields; every variant solves
    # the SAME realizations (pairwise comparable Y per sample). The truth
    # run is ALSO adjoint-corrected: its effective QoI error is the product
    # of its primal/adjoint energy errors (~rtol^2), far below any plain
    # solve at the same rtol - a plain rtol 1e-7 "truth" still carries
    # ~1e-2-grade Y noise at SPE10 contrast (measured on the scaled grid)
    # and would dominate the comparison.
    p0 = build(True, rtols["truth"])
    key = jax.random.PRNGKey(seed)
    xi = p0.sampler.sample(0, key, batch)
    s_f = jnp.asarray(np.asarray(p0.sampler.eval(0, xi)))
    s_c = jnp.asarray(np.asarray(p0.sampler.eval(1, xi, xi_level=0)))

    max_segments = 40

    def run_pair(prob, adjoint, label):
        """Coarse-then-fine warm pair with host-side segmented continuation
        (the managers' split-step logic, managers.py _build_split_step)."""
        solver = prob.solver

        def stage_c(w_c):
            if adjoint:
                qc, _, info, p, lam = solver.solve_fwd(
                    1, w_c, return_pressure=True, return_adjoint=True
                )
                return qc, p, lam, info.iterations, info.converged
            qc, _, info, p = solver.solve_fwd(1, w_c, return_pressure=True)
            return qc, p, None, info.iterations, info.converged

        def stage_f(w_f, p_c, lam_c):
            if adjoint:
                q, _, info, p, lam = solver.solve_fwd_warm(
                    0, w_f, p_c, lam_c=lam_c, return_adjoint=True,
                    return_pressure=True,
                )
                return q, p, lam, info.iterations, info.converged
            q, _, info, p = solver.solve_fwd_warm(0, w_f, p_c, return_pressure=True)
            return q, p, None, info.iterations, info.converged

        def stage_cont(w_f, p_prev, lam_prev):
            if adjoint:
                q, _, info, p, lam = solver.solve_fwd_x0(
                    0, w_f, p_prev, lam0=lam_prev, return_adjoint=True,
                    return_pressure=True,
                )
                return q, p, lam, info.iterations, info.converged
            q, _, info, p = solver.solve_fwd_x0(0, w_f, p_prev, return_pressure=True)
            return q, p, None, info.iterations, info.converged

        jc = jit_hoisted(stage_c, s_c)
        jf = jit_hoisted(stage_f, s_f, jax.ShapeDtypeStruct(s_c.shape, s_c.dtype),
                         jax.ShapeDtypeStruct(s_c.shape, s_c.dtype) if adjoint else None)
        jx = jit_hoisted(stage_cont, s_f, jax.ShapeDtypeStruct(s_f.shape, s_f.dtype),
                         jax.ShapeDtypeStruct(s_f.shape, s_f.dtype) if adjoint else None)

        def once(w_f, w_c):
            iters = 0
            t0 = time.perf_counter()
            qc, p_c, lam_c, it, conv_c = jc(w_c)
            for _ in range(max_segments):
                if bool(np.asarray(conv_c).all()):
                    break
                qc, p_c, lam_c, it2, conv_c = (
                    solver_cont_coarse(w_c, p_c, lam_c)
                )
                it = it + it2
            iters += int(np.asarray(it).max())
            q, p, lam, it, conv = jf(w_f, p_c, lam_c)
            segs = 1
            for _ in range(max_segments):
                if bool(np.asarray(conv).all()):
                    break
                q, p, lam, it2, conv = jx(w_f, p, lam)
                it = it + it2
                segs += 1
            iters += int(np.asarray(it).max())
            np.asarray(q)
            dt = time.perf_counter() - t0
            return (
                np.asarray(q, np.float64),
                np.asarray(qc, np.float64),
                iters,
                segs,
                dt,
                bool(np.asarray(conv).all() and np.asarray(conv_c).all()),
            )

        # Coarse continuation (level 1 converges inside one segment in
        # practice; keep a correct fallback anyway).
        def _cont_c(w_c, p_prev, lam_prev):
            if adjoint:
                qc, _, info, p, lam = solver.solve_fwd_x0(
                    1, w_c, p_prev, lam0=lam_prev, return_adjoint=True,
                    return_pressure=True,
                )
                return qc, p, lam, info.iterations, info.converged
            qc, _, info, p = solver.solve_fwd_x0(1, w_c, p_prev, return_pressure=True)
            return qc, p, None, info.iterations, info.converged

        solver_cont_coarse = jit_hoisted(
            _cont_c, s_c, jax.ShapeDtypeStruct(s_c.shape, s_c.dtype),
            jax.ShapeDtypeStruct(s_c.shape, s_c.dtype) if adjoint else None)

        # Warmup/compile on perturbed fields (distinct from the measured
        # request).
        once(s_f * (1 + 1e-6), s_c * (1 + 1e-6))
        best = None
        for r in range(2):
            cur = once(s_f * (1 + 1e-7 * r), s_c * (1 + 1e-7 * r))
            if best is None or cur[4] < best[4]:
                best = cur
        q, qc, iters, segs, dt, conv = best
        print(
            f"  {label:22s} iters {iters:4d} segs {segs} "
            f"{dt / batch * 1e3:9.1f} ms/sample conv {conv}"
        )
        return {
            "q": q, "qc": qc, "iterations": iters, "segments": segs,
            "sec_per_sample": dt / batch, "converged": conv,
        }

    print(f"SPE10 adjoint-QoI check: grid {grid}, batch {batch}, "
          f"{'CPU f64' if cpu else jax.devices()[0].device_kind + ' f32'}")
    results = {}
    results["truth"] = run_pair(p0, True, f"truth adjoint@{rtols['truth']:g}")
    results["plain"] = run_pair(
        build(False, rtols["plain"]), False, f"plain@{rtols['plain']:g}")
    results["adjoint"] = run_pair(
        build(True, rtols["adjoint"], extra_opts=True), True,
        f"adjoint@{rtols['adjoint']:g}")

    yt = results["truth"]["q"] - results["truth"]["qc"]
    report = {"config": {"grid": list(grid), "batch": batch, "seed": seed,
                         "rtols": rtols, "platform": jax.devices()[0].platform,
                         "adjoint_solver_opts": solver_opts}}
    for name in ("plain", "adjoint"):
        r = results[name]
        y = r["q"] - r["qc"]
        rel_y = np.max(np.abs(y - yt) / np.maximum(np.abs(yt), 1e-30))
        rel_q = np.max(np.abs(r["q"] - results["truth"]["q"])
                       / np.maximum(np.abs(results["truth"]["q"]), 1e-30))
        report[name] = {
            "max_rel_Y_error": float(rel_y),
            "max_rel_Q_error": float(rel_q),
            "iterations": r["iterations"],
            "segments": r["segments"],
            "sec_per_sample": r["sec_per_sample"],
            "converged": r["converged"],
        }
        print(f"  {name:8s} max rel Y err {rel_y:.3e}  max rel Q err "
              f"{rel_q:.3e}  {r['sec_per_sample'] * 1e3:.1f} ms/sample")
    report["truth"] = {
        "iterations": results["truth"]["iterations"],
        "sec_per_sample": results["truth"]["sec_per_sample"],
        "converged": results["truth"]["converged"],
        "E_Y": float(np.mean(yt)),
    }
    with open(out_file, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_file}")


if __name__ == "__main__":
    main()
