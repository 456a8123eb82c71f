"""Smoke run of the MLMC main path on one NVIDIA GPU.

Drives the system through the entry points a user calls
(problems.build_problem -> SPDESampler -> DarcySolver -> MLMCManager) and
checks what comes out. Phases, in order; each prints its findings on lines
of its own and raises on failure (nothing is caught):

  device   JAX must see a GPU; prints its kind, count, name and power limit.
  golden   e2e MLMC on the reference's golden 16^3 box (float32, rtol
           1e-5): estimate within 2.56 +- 0.25, dofs [17152, 2240, 304].
  pair     bench.py's golden fine pair at batch 512: E[Q] within
           2.55 +- 0.12; prints samples/s (a reading, not a benchmark).
  spe10    one batch per level of the full-grid (60x220x85) production
           MLMC at batches 8/128/512 through MLMCManager.init_run: every
           solve converged, finite Y_l, and the level-0 batch's
           adjoint-corrected Q within 1% per sample of a deep (adjoint,
           rtol 1e-6) solve of the same realizations.
  tridiag  every line-solve route against a float64 NumPy Thomas solve at
           the SPE10 level-0 line shapes (n = 61, 221, 86; batch 8) and
           the golden shape at batch 512: max error <= 1e-5 of max |x| for
           the route the solver takes; prints each route's time.
  sampler  the SPDE field on fixed noise against the same tensor solve in
           float64 NumPy, at the golden fine level and the SPE10 coarsest
           level: max relative error of the lognormal field <= 1e-4.
           Prints the error at DEFAULT matmul precision (TF32 on the GPU)
           beside the pinned HIGHEST one.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Options (each runs only its own phases):
  --four-cards      on four cards: the full-grid level-0 Darcy solve with
                    darcy_solver.spatial_shards=4 against the unsharded
                    one-card QoI (rtol 5e-3), per-card memory_stats, and
                    sample-parallel SPE10 levels-1/2 MLMC over a 4-card
                    SampleMesh against the one-card run (law parity
                    within MC error).
  --compare-routes  the tridiag phase, then the SPE10 level-0 production
                    pair end to end with each line-solve route.

Each SPE10 phase traces its programs first and then compiles them all at
once, one thread each; it prints both times, and the compile cache's entry
count at the start and the end.

Usage (from the checkout root): python chip_smoke.py [--four-cards | --compare-routes]
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SPE10_GRID = (60, 220, 85)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _check(phase: str, ok: bool, msg: str) -> None:
    _say(phase, ("ok: " if ok else "FAILED: ") + msg)
    if not ok:
        raise SystemExit(f"chip_smoke: phase {phase} failed: {msg}")


# -- device -------------------------------------------------------------------


def device_phase(count: int = 1) -> dict:
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    _check("device", platform == "gpu",
           f"JAX platform '{platform}' (a GPU is required)")
    _check("device", len(devs) >= count,
           f"{len(devs)} device(s) visible, {count} needed")
    _say("device", f"kind {devs[0].device_kind}, count {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        _say("device", f"nvidia-smi: {line}")
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# -- problems -----------------------------------------------------------------


def golden_config():
    from parelagmc_tpu.config import ProblemConfig

    cfg = ProblemConfig()
    cfg.darcy_solver.relative_tolerance = 1e-5
    cfg.output_filename = ""
    return cfg


def spe10_problem(grid=SPE10_GRID):
    """The examples/spe10_mlmc.py --refinements 2 production problem on
    the synthetic permeability. A grid other than SPE10's own is a box with
    SPE10's extents (the --grid option of that driver; CPU rehearsals)."""
    from examples.spe10_mlmc import full_grid_solver_defaults
    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.mesh.factories import SPE10_NCELLS, SPE10_SPACING
    from parelagmc_tpu.physics.spe10 import load_spe10_kinv
    from parelagmc_tpu.problems import build_problem

    kw = dict(mesh="spe10")
    if tuple(grid) != SPE10_GRID:
        lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
        kw = dict(mesh="box", ncells=tuple(g // 4 for g in grid),
                  lengths=lengths)
    cfg = ProblemConfig(
        refinements=2, correlation_length=100.0, mse=-1.0,
        normalize_marginals=True, axis_order="auto", output_filename="",
        **kw,
    )
    full_grid_solver_defaults(cfg, [])
    kinv = load_spe10_kinv(None, ncells=tuple(grid))
    return cfg, build_problem(cfg, kinv_ref=kinv)


def cold_program(solver, level, w):
    """The hoisted cold Darcy solve of batches shaped like `w`, traced with
    the solver's current config: w -> (q, iterations, converged, p, lam)."""
    from parelagmc_tpu.ops.jit_utils import jit_hoisted

    adjoint = bool(getattr(solver.solver_cfg, "adjoint_qoi", False))

    def cold(w):
        out = solver.solve_fwd(level, w, return_pressure=True,
                               return_adjoint=adjoint)
        return out[0], out[2].iterations, out[2].converged, out[3], (
            out[4] if adjoint else None)

    return jit_hoisted(cold, w)


def converged_solve(solver, level, w, cold=None, max_segments=20):
    """Cold Darcy solve of `w` (with `cold` from cold_program, or one traced
    now) continued across bounded executions until every row converged
    (the managers' segment loop; the continuation program is traced only
    if a segment is needed). Returns (q, iters, converged) on the host."""
    import jax

    from parelagmc_tpu.ops.jit_utils import jit_hoisted

    adjoint = bool(getattr(solver.solver_cfg, "adjoint_qoi", False))

    def cont(w, p, lam):
        out = solver.solve_fwd_x0(level, w, p, return_pressure=True,
                                  lam0=lam, return_adjoint=adjoint)
        return out[0], out[2].iterations, out[2].converged, out[3], (
            out[4] if adjoint else None)

    q, it, conv, p, lam = (cold or cold_program(solver, level, w))(w)
    iters = int(np.asarray(it))
    j_cont = None
    for _ in range(max_segments):
        if bool(np.asarray(conv).all()):
            break
        if j_cont is None:
            ex_p = jax.ShapeDtypeStruct(p.shape, p.dtype)
            j_cont = jit_hoisted(cont, w, ex_p, ex_p if adjoint else None)
        q, it, conv, p, lam = j_cont(w, p, lam)
        iters += int(np.asarray(it))
    return np.asarray(q, np.float64), iters, np.asarray(conv)


def precompile(programs) -> float:
    """aot_compile every program at once, one thread each (XLA compiles
    outside the GIL); later calls and aot_compile reuse the executables.
    Returns the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(programs)) as pool:
        for f in [pool.submit(p.aot_compile) for p in programs]:
            f.result()
    return time.perf_counter() - t0


def cache_entries(cache_dir) -> int:
    import os

    return len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0


# -- golden and pair ----------------------------------------------------------


def golden_phase():
    from parelagmc_tpu.problems import build_problem
    from parelagmc_tpu.uq import MLMCManager

    t0 = time.perf_counter()
    cfg = golden_config()
    prob = build_problem(cfg)
    mgr = MLMCManager(prob.solver, prob.sampler, cfg)
    est = float(mgr.run())
    dofs = [int(prob.solver.num_dofs(l)) for l in range(cfg.nlevels)]
    _say("golden", f"N_l {mgr.level_nsamples.tolist()}, unconverged "
         f"{mgr.level_unconverged.tolist()}, {time.perf_counter() - t0:.1f} s")
    _check("golden", abs(est - 2.56) < 0.25,
           f"estimate {est:.5f} within 2.56 +- 0.25")
    _check("golden", dofs == [17152, 2240, 304], f"dofs {dofs}")
    return prob


def noise_share(sampler, level, batch, step_seconds, reps=20):
    """Seconds per batch of noise generation alone, and its share of a
    step that takes `step_seconds`."""
    import jax

    f = jax.jit(lambda k: sampler.sample(level, k, batch))
    key = jax.random.PRNGKey(1)
    jax.block_until_ready(f(key))
    t0 = time.perf_counter()
    for i in range(reps):
        out = f(jax.random.fold_in(key, i))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return dt, dt / step_seconds


def pair_phase(card: str, batch=512):
    import bench

    t0 = time.perf_counter()
    step, prob = bench.build_pair_step(batch)
    sps, eq = bench.time_pair(step, batch)
    _say("pair", f"{sps:.1f} samples/s at batch {batch} on {card} "
         f"(reading, not a benchmark; {time.perf_counter() - t0:.1f} s "
         f"with compile)")
    dt, share = noise_share(prob.sampler, 0, batch, batch / sps)
    _say("pair", f"noise generation {dt * 1e3:.3f} ms per batch, "
         f"{100 * share:.2f}% of the pair step")
    _check("pair", abs(eq - 2.55) < 0.12, f"E[Q] {eq:.4f} within 2.55 +- 0.12")


# -- SPE10 --------------------------------------------------------------------


def _print_memory_analysis(phase, label, ma):
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    vals = ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(ma, f, 0) / 2**30:.3f} GiB"
        for f in fields
    )
    _say(phase, f"memory_analysis {label}: {vals}")


def spe10_phase(grid=SPE10_GRID, q_rtol=1e-2):
    import jax

    from parelagmc_tpu.uq import MLMCManager
    from parelagmc_tpu.utils.timing import TimeManager

    t0 = time.perf_counter()
    cfg, prob = spe10_problem(grid)
    sampler, solver = prob.sampler, prob.solver
    _say("spe10", f"grid {tuple(grid)}, dofs "
         f"{[int(solver.num_dofs(l)) for l in range(cfg.nlevels)]}, "
         f"solver {cfg.darcy_solver.name}, adjoint "
         f"{cfg.darcy_solver.adjoint_qoi}, rtol "
         f"{cfg.darcy_solver.relative_tolerance}, batches "
         f"{cfg.batch_size_per_level}, build {time.perf_counter() - t0:.1f} s")
    mgr = MLMCManager(solver, sampler, cfg)
    b0 = mgr.level_batch[0]
    # The deep solve's program: the same realizations at rtol 1e-6.
    prod = solver.solver_cfg
    deep_cfg = dataclasses.replace(prod, relative_tolerance=1e-6,
                                   max_iterations=400)
    t0 = time.perf_counter()
    steps = [mgr._step(l) for l in range(cfg.nlevels)]
    solver.solver_cfg = deep_cfg
    try:
        deep = cold_program(solver, 0, jax.ShapeDtypeStruct(
            (b0, solver.levels[0].n_s), solver.dtype))
    finally:
        solver.solver_cfg = prod
    _say("spe10", f"traced every level's pair programs and the deep solve "
         f"in {time.perf_counter() - t0:.1f} s")
    dt = precompile(steps + [deep])
    _say("spe10", f"compiled them in {dt:.1f} s (one thread each)")
    ma = mgr._step(0).memory_analysis()
    for stage, stats in ma.items():
        _print_memory_analysis("spe10", f"level-0 pair {stage}", stats)
    t0 = time.perf_counter()
    mgr.init_run(list(mgr.level_batch))
    _say("spe10", f"one batch per level in {time.perf_counter() - t0:.1f} s")
    for l in range(cfg.nlevels):
        _say("spe10", f"level {l}: batch {mgr.level_batch[l]}, E[Y] "
             f"{mgr.eY[l]:.6g}, E[Q] {mgr.eQ[l]:.6g}, mean iterations "
             f"{mgr._iter_sums[l] / max(1, mgr.level_nsamples[l]):.1f}, "
             f"batch time {TimeManager.last(f'MC Sample -- Level {l}'):.3f} s")
    _check("spe10", int(mgr.level_unconverged.sum()) == 0,
           f"converged fraction 1.0 at every level (unconverged "
           f"{mgr.level_unconverged.tolist()})")
    _check("spe10", bool(np.isfinite(mgr.eY).all()), "finite Y_l")
    step0 = TimeManager.last("MC Sample -- Level 0")
    dt, share = noise_share(sampler, 0, b0, step0)
    _say("spe10", f"level-0 noise generation {dt * 1e3:.3f} ms per batch, "
         f"{100 * share:.3f}% of the level-0 pair batch")

    # Deep solve of the level-0 batch's own realizations.
    last = mgr.last_batch[0]
    xi = sampler.sample(0, last["key"], b0)
    w = jax.block_until_ready(sampler.eval(0, xi))
    solver.solver_cfg = deep_cfg
    try:
        t0 = time.perf_counter()
        q_deep, iters, conv = converged_solve(solver, 0, w, cold=deep)
    finally:
        solver.solver_cfg = prod
    _say("spe10", f"deep solve (adjoint, rtol 1e-6): {iters} iterations, "
         f"{time.perf_counter() - t0:.1f} s")
    _check("spe10", bool(conv.all()), "deep solve converged")
    rel = np.abs(last["q"] - q_deep) / np.abs(q_deep)
    _say("spe10", f"level-0 Q {np.array2string(last['q'], precision=6)}")
    _say("spe10", f"deep Q    {np.array2string(q_deep, precision=6)}")
    _check("spe10", float(rel.max()) <= q_rtol,
           f"level-0 Q max rel error vs deep {rel.max():.3e} <= {q_rtol:g}")
    return cfg, prob


# -- line solves --------------------------------------------------------------


def _rt0_lines(rng, nlines, n, dtype):
    """SPD diagonally dominant RT0 mass lines with a lognormal per-cell
    coefficient (contrast ~e^6), like MassTridiagSolver's tables."""
    w = np.exp(1.5 * rng.standard_normal((nlines, n - 1)))
    m = w / 3.0
    d = np.zeros((nlines, n))
    d[:, :-1] += m
    d[:, 1:] += m
    off = 0.5 * m
    dl = np.concatenate([np.zeros((nlines, 1)), off], axis=1)
    du = np.concatenate([off, np.zeros((nlines, 1))], axis=1)
    b = rng.standard_normal((nlines, n))
    return [x.astype(dtype) for x in (dl, d, du, b)]


def _thomas_f64(dl, d, du, b):
    dl, d, du, b = (np.asarray(x, np.float64) for x in (dl, d, du, b))
    n = b.shape[-1]
    c = np.empty_like(b)
    g = np.empty_like(b)
    cp = gp = 0.0
    for i in range(n):
        den = d[:, i] - dl[:, i] * cp
        c[:, i] = cp = du[:, i] / den
        g[:, i] = gp = (b[:, i] - dl[:, i] * gp) / den
    x = np.empty_like(b)
    xn = 0.0
    for i in range(n - 1, -1, -1):
        x[:, i] = xn = g[:, i] - c[:, i] * xn
    return x


def line_shapes(grid=SPE10_GRID, batch0=8, golden_batch=512):
    """(label, nlines, n): the SPE10 level-0 face lines of each axis and
    the golden fine level's lines."""
    cells = int(np.prod(grid))
    shapes = [(f"spe10 L0 n={g + 1}", batch0 * cells // g, g + 1)
              for g in sorted(grid)]
    shapes.append((f"golden n=17 batch {golden_batch}",
                   golden_batch * 16 * 16, 17))
    return shapes


def _time(f, args, reps=10):
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def tridiag_phase(shapes, routes=("triton", "thomas", "gtsv"), tol=1e-5):
    """Returns {label: {route: seconds}}."""
    import jax
    import jax.numpy as jnp

    from parelagmc_tpu.ops.tridiag import choose_route, route_override, solve_lines

    rng = np.random.default_rng(0)
    times = {}
    for label, nlines, n in shapes:
        host = _rt0_lines(rng, nlines, n, np.float32)
        ref = _thomas_f64(*host)
        scale = float(np.abs(ref).max())
        dev = [jnp.asarray(x) for x in host]
        chosen = choose_route(nlines * n, jnp.float32)
        times[label] = {}
        for route in routes:
            # A fresh function per route: the override acts at trace time.
            with route_override(route):
                f = jax.jit(lambda *a: solve_lines(*a))
                err = float(np.abs(np.asarray(f(*dev), np.float64) - ref).max()) / scale
            t = _time(f, dev)
            times[label][route] = t
            tag = " (chosen)" if route == chosen else ""
            _say("tridiag", f"{label} lines {nlines}: {route}{tag} "
                 f"{t * 1e3:.3f} ms, max err/max|x| {err:.2e}")
            if route == chosen:
                _check("tridiag", err <= tol,
                       f"{label} {route} error {err:.2e} <= {tol:g}")
            elif not err <= 1e-3:
                _say("tridiag", f"note: {route} error {err:.2e} at {label}")
    return times


def sampler_phase(levels, tol=1e-4):
    """levels: [(label, sampler, level)]. The lognormal SPDE field on fixed
    noise against the same tensor solve in float64 NumPy."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from parelagmc_tpu.ops.tensorsolve import tensor_solve

    for label, sampler, level in levels:
        xi = sampler.sample(level, jax.random.PRNGKey(123), 4)
        eig = sampler.eigs[level]
        xi64 = np.asarray(xi, np.float64)
        # float64 host oracle of the same factors.
        V = [np.asarray(v, np.float64) for v in eig.V]
        wsq = np.asarray(eig.w_sqrt, np.float64)
        lam = np.asarray(eig.lam, np.float64).reshape(-1)
        shape = eig.shape
        z = (sampler.g * np.asarray(sampler.w_sqrt[level], np.float64)
             * xi64) / wsq

        def transform(z, transpose):
            zz = z.reshape(z.shape[:-1] + tuple(shape[::-1]))
            for a in range(len(shape)):
                dim = zz.ndim - 1 - a
                M = V[a].T if transpose else V[a]
                zz = np.moveaxis(np.moveaxis(zz, dim, -1) @ M, -1, dim)
            return zz.reshape(z.shape)

        s = transform(transform(z, False) / lam, True) / wsq
        if sampler.field_scale is not None:
            s = s * np.asarray(sampler.field_scale[level], np.float64)
        ref = np.exp(s)
        got = np.asarray(sampler.eval(level, xi), np.float64)
        err_hi = float(np.max(np.abs(got - ref) / ref))

        def default_eval(xi):
            rhs = sampler.g * sampler.w_sqrt[level] * xi
            s = tensor_solve(eig, rhs, precision=lax.Precision.DEFAULT)
            if sampler.field_scale is not None:
                s = s * sampler.field_scale[level]
            return jnp.exp(s)

        got_def = np.asarray(jax.jit(default_eval)(xi), np.float64)
        err_def = float(np.max(np.abs(got_def - ref) / ref))
        _say("sampler", f"{label}: max rel error of the field, DEFAULT "
             f"precision {err_def:.2e}, HIGHEST (pinned) {err_hi:.2e}")
        _check("sampler", err_hi <= tol, f"{label} {err_hi:.2e} <= {tol:g}")


# -- route comparison ---------------------------------------------------------


def route_pair_phase(cfg, prob, routes, batches=4):
    """Level-0 production pair end to end with each line-solve route
    (one segment per pair, so every route does the same iterations).
    Steady time = best of the batches after the first."""
    import jax

    from parelagmc_tpu.ops.tridiag import route_override
    from parelagmc_tpu.uq import MLMCManager

    cfg1 = dataclasses.replace(cfg, solve_segments=1)
    b0 = cfg.batch_size_per_level[0]
    key = jax.random.PRNGKey(5)
    out = {}
    for route in routes:
        t0 = time.perf_counter()
        with route_override(route):
            step = MLMCManager(prob.solver, prob.sampler, cfg1)._step(0)
            step.aot_compile()
        times = []
        for i in range(batches):
            t1 = time.perf_counter()
            q, qc, iters, conv = jax.block_until_ready(
                step(jax.random.fold_in(key, i)))
            times.append(time.perf_counter() - t1)
        steady = min(times[1:])
        out.setdefault(route, []).append(steady)
        _say("routes", f"level-0 pair, route {route}: steady "
             f"{steady / b0 * 1e3:.2f} ms/sample (batches "
             f"{[round(t, 4) for t in times]} s), iterations "
             f"{float(np.asarray(iters).max()):.0f}, converged "
             f"{int(np.asarray(conv).sum())}/{b0}, Q[0] "
             f"{float(np.asarray(q)[0]):.6g}, wall {time.perf_counter() - t0:.1f} s")
    return out


# -- four cards ---------------------------------------------------------------


def _memory_stats(devs):
    out = []
    for d in devs:
        st = d.memory_stats() or {}
        out.append((st.get("bytes_in_use", 0), st.get("peak_bytes_in_use", 0)))
        _say("four-cards", f"{d}: bytes_in_use {out[-1][0] / 2**30:.3f} GiB, "
             f"peak {out[-1][1] / 2**30:.3f} GiB")
    return out


def four_cards_phase(grid=SPE10_GRID, n_cards=4, q_rtol=5e-3):
    """Both runs of each comparison use the production solver with its
    whole segment budget in one program (solve_segments=1, max_iterations
    = segments x the per-program cap): the continuation programs are never
    needed at these batches and would only add compiles."""
    import jax

    from parelagmc_tpu.parallel import SampleMesh
    from parelagmc_tpu.uq import MLMCManager

    devs = jax.devices()[:n_cards]
    t0 = time.perf_counter()
    cfg, prob = spe10_problem(grid)
    sampler, solver = prob.sampler, prob.solver
    b = cfg.batch_size_per_level
    prod = solver.solver_cfg
    run_cfg = dataclasses.replace(
        prod, max_iterations=cfg.solve_segments * prod.max_iterations)
    cfg1 = dataclasses.replace(cfg, solve_segments=1)
    solver.solver_cfg = run_cfg
    _say("four-cards", f"grid {tuple(grid)}, solver {run_cfg.name}, rtol "
         f"{run_cfg.relative_tolerance}, max_iterations "
         f"{run_cfg.max_iterations}, build {time.perf_counter() - t0:.1f} s")

    # Trace every program on the host, then compile them all at once. The
    # one-card programs are traced first, so the solver's cached
    # mean-field starts are made outside any shard_map.
    t0 = time.perf_counter()
    w = jax.block_until_ready(
        sampler.eval(0, sampler.sample(0, jax.random.PRNGKey(7), b[0])))
    cold_1 = cold_program(solver, 0, w)
    runs = {"1 card": MLMCManager(solver, sampler, cfg1),
            "4 cards": MLMCManager(solver, sampler, cfg1,
                                   sharding=SampleMesh(devices=devs))}
    steps = [m._step(l) for m in runs.values() for l in (1, 2)]
    sp_cfg = dataclasses.replace(run_cfg, spatial_shards=n_cards)
    solver.solver_cfg = sp_cfg
    cold_sp = cold_program(solver, 0, w)
    solver.solver_cfg = run_cfg
    _say("four-cards", f"traced 6 programs in {time.perf_counter() - t0:.1f} s")
    dt = precompile([cold_sp, cold_1] + steps)
    _say("four-cards", f"compiled them in {dt:.1f} s (one thread each)")

    # Spatial sharding of the finest level over all cards.
    solver.solver_cfg = sp_cfg
    try:
        t0 = time.perf_counter()
        q_sp, it_sp, conv_sp = converged_solve(solver, 0, w, cold=cold_sp)
    finally:
        solver.solver_cfg = run_cfg
    _say("four-cards", f"level 0 spatial_shards={n_cards}: {it_sp} "
         f"iterations, {time.perf_counter() - t0:.1f} s")
    _say("four-cards", "per-card memory after the spatial solve:")
    stats = _memory_stats(devs)
    _check("four-cards", all(peak > 0 for _, peak in stats),
           "every card held part of the spatial solve (peak bytes > 0)")
    t0 = time.perf_counter()
    q_ref, it_ref, conv_ref = converged_solve(solver, 0, w, cold=cold_1)
    _say("four-cards", f"level 0 unsharded: {it_ref} iterations, "
         f"{time.perf_counter() - t0:.1f} s")
    _check("four-cards", bool(conv_ref.all() and conv_sp.all()),
           "both level-0 solves converged")
    rel = float(np.max(np.abs(q_sp - q_ref) / np.abs(q_ref)))
    _check("four-cards", rel <= q_rtol,
           f"spatial vs unsharded level-0 Q max rel {rel:.3e} <= {q_rtol:g}")

    # Sample-parallel levels 1/2 against the one-card run.
    for name, mgr in runs.items():
        t0 = time.perf_counter()
        mgr.init_run([0, 2 * b[1], 2 * b[2]])
        _say("four-cards", f"sample-parallel levels 1/2, {name}: E[Q] "
             f"{mgr.eQ[1]:.6g}/{mgr.eQ[2]:.6g}, E[Y_1] {mgr.eY[1]:.6g}, "
             f"unconverged {mgr.level_unconverged.tolist()}, "
             f"{time.perf_counter() - t0:.1f} s")
        _check("four-cards", int(mgr.level_unconverged.sum()) == 0,
               f"{name}: every solve converged")
    m4, m1 = runs["4 cards"], runs["1 card"]
    for l in (1, 2):
        n4, n1 = float(m4.level_nsamples[l]), float(m1.level_nsamples[l])
        for name, mu4, mu1, v4, v1 in (
            ("Q", m4.eQ[l], m1.eQ[l], m4.varQ[l], m1.varQ[l]),
            ("Y", m4.eY[l], m1.eY[l], m4.varY[l], m1.varY[l]),
        ):
            se = float(np.sqrt(v4 / n4 + v1 / n1))
            diff = abs(float(mu4 - mu1))
            _check("four-cards", diff <= 6 * se + 1e-12,
                   f"level {l} E[{name}] 4 cards vs 1 card: |diff| "
                   f"{diff:.3e} <= 6 se = {6 * se:.3e}")
    _say("four-cards", "per-card memory at the end:")
    _memory_stats(devs)
    solver.solver_cfg = prod


# -- main ---------------------------------------------------------------------


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    unknown = set(argv) - {"--four-cards", "--compare-routes"}
    if unknown or len(argv) > 1:
        raise SystemExit(f"usage: python chip_smoke.py "
                         f"[--four-cards | --compare-routes] (got {argv})")
    from parelagmc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    entries = cache_entries(cache)
    t_start = time.perf_counter()
    if "--four-cards" in argv:
        device = device_phase(count=4)
        _say("device", f"compile cache {cache} ({entries} entries)")
        four_cards_phase()
        device = dict(device, count=4)
    else:
        device = device_phase()
        _say("device", f"compile cache {cache} ({entries} entries)")
        if "--compare-routes" in argv:
            tridiag_phase(line_shapes(), routes=("triton", "thomas", "gtsv"))
            cfg, prob = spe10_problem()
            route_pair_phase(cfg, prob, ("triton", "gtsv", "thomas", "triton"))
        else:
            golden = golden_phase()
            pair_phase(device["kind"])
            cfg, prob = spe10_phase()
            tridiag_phase(line_shapes())
            sampler_phase([
                ("golden fine level", golden.sampler, 0),
                ("spe10 coarsest level", prob.sampler, cfg.nlevels - 1),
            ])
    _say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
         f"compile cache {cache} now holds {cache_entries(cache)} entries")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
