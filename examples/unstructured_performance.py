"""Unstructured/agglomerated-path device throughput with scipy baseline.

North-star BASELINE.json configs[3] ("MLMC estimator: SPDE sampler + Darcy
QoI on cube_tet.mesh, 4-level agglomerated hierarchy") - the reference's
defining capability is MLMC on *general unstructured meshes*
(/root/reference/README.md:31-38, examples/MLMC.cpp on meshes/cube_tet.mesh)
This harness measures the unstructured stack end to end:

  * Per level: the MLMC coupled pair step (UnstructuredSPDESampler
    eval_pair + UnstructuredDarcySolver solve_fwd_pair) in samples/s on
    the device, with mean Krylov iterations and a converged_fraction
    canary; the coarsest level times the single-solve Q step.
  * A single-core scipy baseline on the SAME operators (assemble M(w) +
    sparse-LU of the fine+coarse saddle pair per sample - the bench.py
    methodology), giving an honest per-level vs-baseline ratio, plus a
    QoI ORACLE: the device Q must match the scipy Q on identical w.
  * Solver-variant comparison (minres-bj / minres-coefmg / hybrid-cg) -
    the measured basis for the production pick.
  * A per-iteration profile at level 0 by iteration differencing (two
    fixed-budget runs) and a batched ELL-SpMV chain amortization - where
    the time goes.

Mesh: cube_tet.mesh refined --refine times (6 * 8^r tets), then
agglomerated --levels deep with --coarsening-factor (the reference's
METIS workflow, src/Utilities.cpp:125-155). Timing discipline: distinct
PRNG keys and a host fetch per measured call.

Usage (on the GPU, from the checkout root):
    python examples/unstructured_performance.py [--refine 4] [--levels 4]
        [--batch 128] [--compare]
Writes unstructured_performance.json.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.agglomeration import build_agglomerated_hierarchy
from parelagmc_tpu.mesh.mfem_io import read_mfem_mesh
from parelagmc_tpu.ops.jit_utils import jit_hoisted
from parelagmc_tpu.unstructured import (
    UnstructuredDarcySolver,
    UnstructuredSPDESampler,
    label_box_boundaries_gm,
)

MESHES = "/root/reference/meshes"


def timed(fn, key, batch, reps, label):
    t0 = time.perf_counter()
    warm = fn(jax.random.fold_in(key, 987654))
    q0 = np.asarray(warm[0])
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(q0)):
        raise RuntimeError(f"{label}: warmup produced non-finite Q")
    dt, outs = np.inf, None
    for r in range(3):
        t0 = time.perf_counter()
        cur = [fn(jax.random.fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
        _ = [np.asarray(o[0]) for o in cur]
        d = time.perf_counter() - t0
        if d < dt:
            dt, outs = d, cur
    n = reps * batch
    iters = float(np.mean([np.asarray(o[2]) for o in outs]))
    conv = float(np.mean([np.asarray(o[1], np.float64) for o in outs]))
    print(
        f"  {label:30s} {dt / n * 1e3:10.4f} ms/sample "
        f"{n / dt:10.1f} samples/s  iters {iters:.1f} conv {conv * 100:.0f}% "
        f"(compile {compile_s:.1f}s)"
    )
    row = {
        "sec_per_sample": dt / n,
        "samples_per_sec": n / dt,
        "mean_iterations": iters,
        "converged_fraction": conv,
        "compile_sec": compile_s,
    }
    if conv < 1.0:
        print(f"  !! {label}: only {conv * 100:.0f}% converged - capture INVALID")
    return row


def scipy_pair_baseline(hier, solver, level, nmeas=3):
    """Single-core reference-style cost: assemble M(w) + sparse-LU the
    fine and coarse saddle systems per sample, on the SAME operators and
    rhs the device solver uses (cf. bench.py _scipy_baseline)."""
    rng = np.random.default_rng(0)
    static = []
    lvls = [level] if level == hier.nlevels - 1 else [level, level + 1]
    for l in lvls:
        lvl = hier.levels[l]
        ess = np.asarray(solver._lv[l]["ess"])
        keep = sp.diags((~ess).astype(np.float64))
        ident = sp.diags(ess.astype(np.float64))
        B = (lvl.b_csr() @ keep).tocsr()
        b = np.asarray(solver._lv[l]["rhs"], dtype=np.float64)
        static.append((lvl, keep, ident, B, b))
    times = []
    for _ in range(max(nmeas, 3)):
        t0 = time.perf_counter()
        for lvl, keep, ident, B, b in static:
            w = np.exp(rng.normal(size=lvl.n_s))
            M = keep @ lvl.mass_csr(w) @ keep + ident
            A = sp.bmat([[M, B.T], [B, None]], format="csc")
            spla.splu(A).solve(b)
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def scipy_qoi_oracle(hier, solver, level, w):
    """Direct sparse solve of the same saddle system: the device Q must
    match (dense/scipy oracle convention, CLAUDE.md)."""
    lvl = hier.levels[level]
    ess = np.asarray(solver._lv[level]["ess"])
    keep = sp.diags((~ess).astype(np.float64))
    ident = sp.diags(ess.astype(np.float64))
    B = (lvl.b_csr() @ keep).tocsr()
    M = keep @ lvl.mass_csr(np.asarray(w, np.float64)) @ keep + ident
    A = sp.bmat([[M, B.T], [B, None]], format="csc")
    b = np.asarray(solver._lv[level]["rhs"], dtype=np.float64)
    x = spla.splu(A).solve(b)
    return float(x @ np.asarray(solver._lv[level]["obs"], np.float64))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default=f"{MESHES}/cube_tet.mesh")
    p.add_argument("--refine", type=int, default=4,
                   help="uniform refinements of the file mesh before "
                        "agglomeration (6 * 8^r tets)")
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--coarsening-factor", type=int, default=8)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--solver", default="hybrid-cg")
    p.add_argument("--compare", action="store_true",
                   help="also time minres-bj and minres-coefmg")
    p.add_argument("--rtol", type=float, default=1e-5,
                   help="reachable in f32 at refine-4 scale since the "
                        "algebraic hybridization of agglomerated levels "
                        "(68-102 pair iterations, conv 100%%); the old "
                        "MINRES coarse path stalled below 1e-4 in f32")
    p.add_argument("--max-iterations", type=int, default=800,
                   help="batch-max Krylov budget: the cold agglomerated "
                        "coarse MINRES needs ~370 at batch 8 and the "
                        "batch-128 worst sample more")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--corlen", type=float, default=0.3)
    p.add_argument("--variance", type=float, default=0.25)
    p.add_argument("--out", default="unstructured_performance.json")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU (smoke test)")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32

    from parelagmc_tpu.fem.simplicial_hierarchy import refine_simplicial

    gm = read_mfem_mesh(args.mesh)
    label_box_boundaries_gm(gm)
    for _ in range(args.refine):
        gm, _ = refine_simplicial(gm)
    t0 = time.perf_counter()
    hier = build_agglomerated_hierarchy(
        gm, args.levels, coarsening_factor=args.coarsening_factor
    )
    setup_hier_s = time.perf_counter() - t0
    print(f"-- hierarchy: {[l.n_s for l in hier.levels]} cells, "
          f"{[l.n_u for l in hier.levels]} faces (built {setup_hier_s:.1f}s)")

    def make(name):
        cfg = ProblemConfig(
            refinements=args.levels - 1,
            correlation_length=args.corlen,
            variance=args.variance,
            batch_size=args.batch,
            dtype=args.dtype,
        )
        cfg.darcy_solver.name = name
        cfg.darcy_solver.relative_tolerance = args.rtol
        cfg.darcy_solver.max_iterations = args.max_iterations
        t0 = time.perf_counter()
        solver = UnstructuredDarcySolver(hier, cfg, dtype)
        return cfg, solver, time.perf_counter() - t0

    cfg, solver, setup_s = make(args.solver)
    sampler = UnstructuredSPDESampler(hier, cfg, dtype)
    key = jax.random.PRNGKey(0)
    batch = args.batch
    reps = max(2, args.samples // batch)

    evidence = {
        "mesh": f"{args.mesh} x{args.refine} refinements",
        "cells": [int(l.n_s) for l in hier.levels],
        "faces": [int(l.n_u) for l in hier.levels],
        "coarsening_factor": args.coarsening_factor,
        "batch": batch,
        "rtol": args.rtol,
        "dtype": args.dtype,
        "solver": args.solver,
        "setup_sec": {"hierarchy": setup_hier_s, "solver": setup_s},
        "levels": [],
        "variants": {},
    }

    # QoI oracle on level 0 (device vs scipy, identical w).
    rng = np.random.default_rng(7)
    w_or = np.exp(args.variance ** 0.5 * rng.normal(size=hier.levels[0].n_s))
    q_dev = float(np.asarray(
        solver.solve_fwd(0, jnp.asarray(w_or[None], dtype=dtype))[0]
    )[0])
    q_sp = scipy_qoi_oracle(hier, solver, 0, w_or)
    evidence["qoi_oracle"] = {
        "q_device": q_dev, "q_scipy": q_sp,
        "rel_err": abs(q_dev - q_sp) / abs(q_sp),
    }
    print(f"-- QoI oracle level 0: device {q_dev:.6g} vs scipy {q_sp:.6g} "
          f"(rel {evidence['qoi_oracle']['rel_err']:.1e})")

    print(f"-- MLMC pair throughput ({args.solver}, batch {batch})")
    for level in range(hier.nlevels):
        if level < hier.nlevels - 1:

            def step(k, level=level):
                xi = sampler.sample(level, k, batch)
                s_f, s_c = sampler.eval_pair(level, xi)
                q, qc, i_f, i_c = solver.solve_fwd_pair(level, s_f, s_c)
                return (
                    q - qc,
                    i_f.converged & i_c.converged,
                    i_f.iterations + i_c.iterations,
                )

            label = f"L{level} pair"
        else:

            def step(k, level=level):
                xi = sampler.sample(level, k, batch)
                s = sampler.eval(level, xi)
                q, _, info = solver.solve_fwd(level, s)
                return q, info.converged, info.iterations

            label = f"L{level} single"
        row = {"level": level,
               "darcy_dofs": int(solver.num_dofs(level)),
               "batch": batch}
        row["pair"] = timed(jit_hoisted(step, key), key, batch, reps, label)
        base = scipy_pair_baseline(hier, solver, level)
        row["scipy_sec_per_sample_1core"] = base
        row["vs_scipy_1core"] = base / row["pair"]["sec_per_sample"]
        row["vs_64rank_proxy"] = row["vs_scipy_1core"] / 64.0
        print(f"    scipy 1-core {base * 1e3:.2f} ms/sample -> "
              f"{row['vs_scipy_1core']:.1f}x (1-core), "
              f"{row['vs_64rank_proxy']:.2f}x (64-rank proxy)")
        evidence["levels"].append(row)

    if args.compare:
        print("-- solver variants, level-0 pair")
        for name in ("minres-bj", "minres-coefmg", "hybrid-cg"):
            if name == "minres-bj":
                cfg_v = ProblemConfig(
                    refinements=args.levels - 1, batch_size=batch,
                    correlation_length=args.corlen, variance=args.variance,
                    dtype=args.dtype,
                )
                cfg_v.darcy_solver.relative_tolerance = args.rtol
                cfg_v.darcy_solver.max_iterations = args.max_iterations
                sol_v = UnstructuredDarcySolver(hier, cfg_v, dtype)
            else:
                _, sol_v, _ = make(name)

            def step_v(k, sol_v=sol_v):
                xi = sampler.sample(0, k, batch)
                s_f, s_c = sampler.eval_pair(0, xi)
                q, qc, i_f, i_c = sol_v.solve_fwd_pair(0, s_f, s_c)
                return (
                    q - qc,
                    i_f.converged & i_c.converged,
                    i_f.iterations + i_c.iterations,
                )

            evidence["variants"][name] = timed(
                jit_hoisted(step_v, key), key, batch, reps, name
            )

    # Per-iteration profile at level 0 by iteration differencing (fixed
    # budgets m and 2m at rtol=0: dt difference isolates the Krylov body
    # from setup/QoI).
    import dataclasses

    m_it = 24
    prof = {}
    w_prof = jnp.asarray(
        np.exp(args.variance ** 0.5
               * np.random.default_rng(3).normal(size=(batch, hier.levels[0].n_s))),
        dtype=dtype,
    )
    for tag, budget in (("m", m_it), ("2m", 2 * m_it)):
        sol_p = solver
        old = sol_p.solver_cfg
        sol_p.solver_cfg = dataclasses.replace(
            old, max_iterations=budget, relative_tolerance=0.0,
            absolute_tolerance=0.0,
        )

        def fixed(w, sol_p=sol_p):
            q, _, info = sol_p.solve_fwd(0, w)
            return q, info.iterations

        f = jit_hoisted(fixed, w_prof)
        np.asarray(f(w_prof)[0])
        t0 = time.perf_counter()
        for i in range(4):
            np.asarray(f(w_prof * (1.0 + 1e-6 * i))[0])
        prof[tag] = (time.perf_counter() - t0) / 4
        sol_p.solver_cfg = old
    per_iter = (prof["2m"] - prof["m"]) / m_it
    evidence["profile_level0"] = {
        "fixed_budget_sec": prof,
        "sec_per_krylov_iteration_batch": per_iter,
        "ms_per_iteration_per_sample": per_iter / batch * 1e3,
    }
    print(f"-- level-0 per-iteration cost: {per_iter * 1e3:.2f} ms/batch-iter "
          f"({per_iter / batch * 1e6:.1f} us/sample-iter)")

    with open(args.out, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"written: {args.out}")
    return evidence


if __name__ == "__main__":
    main()
