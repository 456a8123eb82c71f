"""SPE10-scale performance for the embedded and projection SPDE samplers.

Reference analog: the OTHER TWO of the reference's three SPE10 performance
harnesses - examples/SPE10/SPE10_EmbeddedPDESampler_Performance.cpp and
SPE10_ProjectionPDESampler_Performance.cpp (per-level Sample+Eval timers),
plus the L2-projector assemble/apply timers of
src/L2ProjectionPDESampler.cpp:499-525. The plain-sampler harness at scale
is examples/spe10_performance.py; this one closes the trio and writes
spe10_sampler_performance.json.

Grid: the embedded hierarchies need per-axis cell counts divisible by
2^refinements so the enlarged-mesh levels coarsen in lockstep with the
original (parelagmc_tpu/problems.py guard); SPE10's z = 85 is odd, so the
harness runs all three variants on 60x220x84 cells with the true SPE10
domain extents (1200x2200x170 ft) - stated honestly in the evidence JSON.
The buffer is 1 coarse layer (= 2^refinements fine layers) per side, so
the embedded solve grid is 68x228x92 (~1.43M cells vs 1.16M original).

What is measured per level and variant (f32, distinct PRNG keys and a
host fetch per measured call):
  * sample_eval: xi -> field on the ORIGINAL mesh (the estimator's input
    path: noise, tensor-spectral SPDE solve on the solve mesh, selection /
    mortar projection back). Tensor solves are EXACT (no Krylov, so no
    converged_fraction; finiteness + moment sanity are the canaries).
  * embed_eval (embedded/projection): same without the final restriction -
    the difference isolates the selection-gather / mortar-ELL cost.
  * projector_apply (projection only): the standalone G apply + W^-1 scale
    (reference "L2 Projector: Apply" timer).
  * memory: compile-only memory_analysis of the batched sample_eval program.

Usage (on the GPU, from the checkout root):
    python examples/spe10_sampler_performance.py [--samples 256]
        [--batch 256] [--variants plain,matching,projection]
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
from parelagmc_tpu.problems import build_problem

GRID = (60, 220, 84)  # embed-aligned SPE10 grid (z=85 is odd; see docstring)
EXTENTS = (1200.0, 2200.0, 170.0)  # true SPE10 ft extents


def timed(fn, key, batch, reps, label):
    """Best-of-3 rounds of `reps` calls with distinct keys + host fetch."""
    t0 = time.perf_counter()
    w = np.asarray(fn(jax.random.fold_in(key, 987654))[0])
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(w)):
        raise RuntimeError(f"{label}: warmup produced non-finite values")
    dt = np.inf
    for r in range(3):
        t0 = time.perf_counter()
        outs = [fn(jax.random.fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
        _ = [np.asarray(o[0]) for o in outs]
        d = time.perf_counter() - t0
        dt = min(dt, d)
    n = reps * batch
    print(
        f"  {label:26s} {dt / n * 1e3:10.4f} ms/sample "
        f"{n / dt:12.1f} samples/s (compile {compile_s:.1f}s)"
    )
    return {
        "sec_per_sample": dt / n,
        "samples_per_sec": n / dt,
        "compile_sec": compile_s,
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def _pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            v = cast(argv[i + 1])
            del argv[i: i + 2]
            return v
        return default

    variants = _pop("--variants", "plain,matching,projection", str).split(",")
    out_file = _pop("--out", "spe10_sampler_performance.json", str)
    grid = _pop("--grid", None, lambda s: tuple(int(x) for x in s.split(",")))
    grid = grid if grid is not None else GRID

    evidence = {
        "grid": f"{grid[0]}x{grid[1]}x{grid[2]} cells, SPE10 extents "
                "1200x2200x170 ft (z=84 default: embedded hierarchies need "
                "divisibility by 2^refinements; SPE10's z=85 is odd)",
        "buffer": "1 coarse layer per side (embedded solve grid 68x228x92)",
        "variants": {},
    }
    for variant in variants:
        embedding = {"plain": "none", "matching": "matching",
                     "projection": "projection"}[variant]
        cfg = parse_config(
            list(argv),
            mesh="box",
            refinements=2,
            correlation_length=100.0,
            initial_samples=256,
            batch_size=256,
            normalize_marginals=True,
            axis_order="auto",
            embedding=embedding,
        )
        # Scaled box with the SPE10 extents: ncells is the COARSEST mesh.
        f = 2 ** cfg.refinements
        import dataclasses

        cfg = dataclasses.replace(
            cfg, ncells=tuple(g // f for g in grid), lengths=EXTENTS
        )
        prob = build_problem(cfg)
        sampler = prob.sampler
        batch = cfg.batch_size
        reps = max(2, cfg.initial_samples // batch)
        key = jax.random.PRNGKey(cfg.seed)
        rows = []
        print(f"-- variant {variant}: batch {batch}, {cfg.nlevels} levels")
        for level in range(cfg.nlevels):
            row = {
                "level": level,
                "solve_dofs": int(sampler.sample_size(level)),
                "field_dofs": int(sampler.field_size(level))
                if hasattr(sampler, "field_size")
                else int(sampler.sample_size(level)),
                "batch": batch,
            }

            def sample_eval(k, level=level):
                s = sampler.eval(level, sampler.sample(level, k, batch))
                # Fetch O(batch) per-sample moments, not the O(n_s) field:
                # the host transfer would dominate otherwise.
                return jnp.mean(s, axis=-1), jnp.std(s, axis=-1)

            fn = jit_hoisted(sample_eval, key)
            if level == 0:
                try:
                    ma = fn.memory_analysis()
                    row["hbm_bytes"] = int(
                        ma.temp_size_in_bytes + ma.argument_size_in_bytes
                        + ma.output_size_in_bytes
                    )
                    print(f"  level-0 HBM (args+temp+out): "
                          f"{row['hbm_bytes'] / 1e9:.2f} GB")
                except Exception as e:  # CPU backends lack the API
                    print(f"  (memory_analysis unavailable: {e})")
            row["sample_eval"] = timed(fn, key, batch, reps, "Sample+Eval")
            # Moment sanity canary on the warmup leg: lognormal mean of the
            # normalized field should sit near exp(sigma^2/2) with sigma^2
            # = variance (field mean over 1.16M cells, batch-averaged).
            mcheck = jit_hoisted(sample_eval, key)(jax.random.fold_in(key, 5))
            row["field_mean"] = float(np.mean(np.asarray(mcheck[0])))
            row["field_std"] = float(np.mean(np.asarray(mcheck[1])))

            if embedding != "none":

                def embed_eval(k, level=level):
                    s = sampler.embed_eval(level, sampler.sample(level, k, batch))
                    return jnp.mean(s, axis=-1), jnp.std(s, axis=-1)

                row["embed_eval"] = timed(
                    jit_hoisted(embed_eval, key), key, batch, reps, "EmbedEval"
                )
                row["restriction_overhead_ms"] = (
                    row["sample_eval"]["sec_per_sample"]
                    - row["embed_eval"]["sec_per_sample"]
                ) * 1e3
            if embedding == "projection":
                # Standalone mortar apply (reference "L2 Projector: Apply").
                s_embed = sampler.embed_eval(
                    level, sampler.sample(level, jax.random.fold_in(key, 3), batch)
                )

                def proj(k, level=level, s_embed=s_embed):
                    # Key-dependent scale: every call projects a new field
                    # while keeping the ELL apply the measured op.
                    c = jax.random.uniform(k, ()) + 0.5
                    p = sampler.project(level, s_embed * c)
                    return jnp.mean(p, axis=-1), None

                row["projector_apply"] = timed(
                    jit_hoisted(proj, key), key, batch, reps, "Projector apply"
                )
            rows.append(row)
        evidence["variants"][variant] = rows

    with open(out_file, "w") as fjson:
        json.dump(evidence, fjson, indent=1)
    print(f"wrote {out_file}")
    return evidence


if __name__ == "__main__":
    main()
