"""Benchmark: MLMC sample throughput on the golden Darcy configuration.

Measures samples/sec/card of the dominant MLMC cost - the finest-level
coupled pair step (SPDE Matern realization on 16^3 + Darcy solves on 16^3
and 8^3 + QoI), i.e. the reference's per-sample hot loop
(/root/reference/src/MLMC_Manager.cpp:144-157) on the golden test problem
(4^3 hex cube of side 2, refined twice).

Runs on the GPU and fails when JAX finds none. Prints ONE JSON line:
  {"metric": ..., "value": samples/sec/card, "unit": "samples/s",
   "vs_baseline": value / (64 * single-core scipy samples/sec),
   "device": {"platform", "kind", "count"}}

The baseline proxy is a direct sparse-LU solve of the same fine+coarse
saddle systems with scipy on one host core, scaled by 64 to stand in for
the 64-rank MPI CPU baseline of BASELINE.md (the reference publishes no
absolute numbers; see BASELINE.md).

Usage: python bench.py [--recalibrate]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

PAIR_BATCH = 512


def build_pair_step(batch: int = PAIR_BATCH):
    """Jitted golden fine-pair step key -> (Q_fine, Y) for `batch` samples."""
    import jax

    from parelagmc_tpu.config import ProblemConfig
    from parelagmc_tpu.ops.jit_utils import jit_hoisted
    from parelagmc_tpu.problems import build_problem

    cfg = ProblemConfig(batch_size=batch)
    # 50-iteration budget + per-cell sqrt(w)-scaled exact Schur
    # preconditioner for the warm-started coarse-then-fine pair
    # (solve_fwd_pair): measured QoI bias -0.008 / rmse 0.065 vs a
    # 300-iteration rtol-1e-6 reference on this config - well inside the
    # golden epsilon = 0.032 MLMC error target's sampling noise. rtol 1e-4
    # is the f32 Krylov floor.
    cfg.darcy_solver.relative_tolerance = 1e-4
    cfg.darcy_solver.max_iterations = 50
    cfg.darcy_solver.local_schur_scaling = True
    prob = build_problem(cfg)
    sampler, solver = prob.sampler, prob.solver

    def pair_step(key):
        xi = sampler.sample(0, key, batch)
        s_f = sampler.eval(0, xi)
        s_c = sampler.eval(1, xi, xi_level=0)
        q, qc, _, _ = solver.solve_fwd_pair(0, s_f, s_c)
        return q, q - qc

    step = jit_hoisted(pair_step, jax.random.PRNGKey(0))
    return step, prob


def time_pair(step, batch: int = PAIR_BATCH, reps: int = 8, rounds: int = 3):
    """(samples/s, E[Q]): best of `rounds` rounds of `reps` steps, each on
    its own key, every result fetched to the host."""
    import jax

    key = jax.random.PRNGKey(0)
    np.asarray(step(key)[0])  # compile + first execution
    best_dt, eq = np.inf, 0.0
    for r in range(rounds):
        t0 = time.perf_counter()
        outs = [step(jax.random.fold_in(key, 100 * r + i)) for i in range(reps)]
        qs = [np.asarray(o[0]) for o in outs]
        dt = time.perf_counter() - t0
        if dt < best_dt:
            best_dt, eq = dt, float(np.mean(qs))
    return reps * batch / best_dt, eq


def main() -> None:
    from parelagmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found only '{dev.platform}'")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    batch = PAIR_BATCH
    step, prob = build_pair_step(batch)
    sps, eq = time_pair(step, batch)
    print(f"# {device['kind']}: {sps:.1f} samples/s; E[Q]~{eq:.4f}",
          file=sys.stderr)
    # Correctness gate: the deep-converged truth on this config/keys is
    # E[Q] = 2.55 +- ~0.03 sampling noise and the 50-iteration budget bias
    # is < 0.01; a wrong program shows up as a mean shift long before
    # anything NaNs.
    if abs(eq - 2.55) > 0.12:
        print(
            f"# !! E[Q]={eq:.4f} outside the converged-truth band "
            f"2.55 +- 0.12; treat this capture as INVALID",
            file=sys.stderr,
        )
    hier, solver = prob.hierarchy, prob.solver

    # --- single-core scipy baseline proxy (sparse LU per sample) -----------
    # The divisor is PINNED in BASELINE_CALIBRATION.json (calibrated once on
    # an idle host): re-measuring it at bench time made vs_baseline swing
    # ~45% with concurrent host load. Pass --recalibrate on an idle host to
    # refresh the pin; the live measurement is still taken and reported so
    # drift is visible.
    import os

    calib_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "BASELINE_CALIBRATION.json")
    live_sec = 1.0 / _scipy_baseline(hier, solver, nmeas=3)
    if "--recalibrate" in sys.argv:
        calib = {
            "cpu_sec_per_sample": round(live_sec, 4),
            "what": "single-core scipy sparse-LU fine+coarse saddle pair, "
                    "golden 16^3 config (see bench.py _scipy_baseline)",
            "note": "calibrate on an idle host only (--recalibrate)",
        }
        with open(calib_path, "w") as f:
            json.dump(calib, f, indent=1)
    elif os.path.exists(calib_path):
        with open(calib_path) as f:
            calib = json.load(f)
    else:
        # No pin and not asked to create one: use the live measurement for
        # THIS report but do not persist it - silently pinning a divisor
        # measured on a possibly-loaded host would bake the very drift the
        # pin exists to remove (review r3). The JSON marks the divisor
        # unpinned so the reader knows it is load-sensitive.
        calib = {"cpu_sec_per_sample": live_sec, "unpinned_live": True}
    pinned_sec = float(calib["cpu_sec_per_sample"])
    vs = sps * pinned_sec / 64.0
    print(
        json.dumps(
            {
                "metric": "MLMC fine-pair samples/sec/card (SPDE sampler + Darcy QoI, golden 16^3 config)",
                "value": round(sps, 2),
                "unit": "samples/s",
                "vs_baseline": round(vs, 3),
                "baseline_sec_per_sample": pinned_sec,
                "baseline_sec_per_sample_live": round(live_sec, 4),
                "device": device,
            }
        )
    )


def _scipy_baseline(hier, solver, nmeas: int = 3) -> float:
    """Reference-style per-sample cost on one CPU core: assemble + sparse-LU
    the fine and coarse saddle systems per sample."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(0)
    # Static per-level structures (the reference amortizes these too).
    static = []
    for level in (0, 1):
        lvl = hier.levels[level]
        ess = np.asarray(solver.levels[level].ess)
        keep = sp.diags((~ess).astype(np.float64))
        ident = sp.diags(ess.astype(np.float64))
        B = (lvl.b_csr() @ keep).tocsr()
        b = np.asarray(solver.levels[level].rhs, dtype=np.float64)
        static.append((lvl, keep, ident, B, b))
    times = []
    for _ in range(max(nmeas, 5)):
        t0 = time.perf_counter()
        for lvl, keep, ident, B, b in static:
            w = np.exp(rng.normal(size=lvl.n_s))
            M = keep @ lvl.mass_csr(w) @ keep + ident
            A = sp.bmat([[M, B.T], [B, None]], format="csc")
            spla.splu(A).solve(b)
        times.append(time.perf_counter() - t0)
    # Minimum is robust against concurrent host load (don't flatter the GPU
    # with an overloaded CPU baseline).
    per_sample = float(np.min(times))
    print(f"# cpu single-core: {per_sample:.4f} s/sample", file=sys.stderr)
    return 1.0 / per_sample


if __name__ == "__main__":
    main()
