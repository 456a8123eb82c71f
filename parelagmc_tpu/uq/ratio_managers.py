"""Bayesian posterior ratio estimators, single-level and multilevel.

Batched JAX re-design of the reference's four managers
(/root/reference/src/SL_BayesRatio_Manager.hpp,
SL_BayesRatio_Splitting_Manager.hpp, ML_BayesRatio_Manager.hpp,
ML_BayesRatio_Splitting_Manager.hpp):

* ratio estimator:     E_post[Q] ~= (sum_l E[Y_R,l]) / (sum_l E[Y_Z,l]),
  with independent prior streams for Z = Pi(u) and R = Q(u') Pi(u')
  (reference ML_BayesRatio_Manager.hpp:314-430: zxi and xi are separate
  draws) and coupled coarse/fine evaluations sharing each stream's noise.
* splitting estimator: E_post[Q] ~= sum_l E[R_l/Z_l - R_{l+1}/Z_{l+1}]
  ("divide then subtract", reference ML_BayesRatio_Splitting_Manager.hpp:26-29).

Single-level variants are the nlevels == 1 special case. The execution
model matches MLMCManager: one fused, batched jit program per level; all
moment sums accumulated on host in float64. Sample allocation follows the
reference: optimal-N_l against the max of the R- and Z-stream estimator
variances (ratio) or the Y_Ratio variance (splitting)
(ML_BayesRatio_Manager.hpp:686-724).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.uq.bayes import BayesianInverseProblem
from parelagmc_tpu.utils.regression import exp_weighted_regression
from parelagmc_tpu.utils.timing import TimeManager

# Moment columns (reference ML_BayesRatio_Manager.hpp:67-70 enum).
(YZ2, YZ, ABS_YZ, Z2, Z, ABS_Z, YR2, YR, ABS_YR, R2, R, ABS_R,
 YRATIO2, YRATIO, ABS_YRATIO, RATIO2, RATIO, ABS_RATIO, C, T) = range(20)
NVAR = 20


class BayesRatioManager:
    """Adaptive Bayesian ratio / splitting estimator manager."""

    def __init__(
        self,
        problem: BayesianInverseProblem,
        config: ProblemConfig,
        nlevels: Optional[int] = None,
        splitting: bool = False,
        batch_size: Optional[int] = None,
        sharding=None,  # Optional[parallel.SampleMesh]: shard batches over 'dp'
    ):
        self.problem = problem
        self.config = config
        self.splitting = bool(splitting)
        if sharding is None:
            # config.sample_shards / --sample-shards (cf. MLMCManager).
            from parelagmc_tpu.parallel.sharding import sample_mesh_from_config

            sharding = sample_mesh_from_config(config)
        self.sharding = sharding
        if sharding is not None and int(
            getattr(config.darcy_solver, "spatial_shards", 0) or 0
        ) > 1:
            # Same invalid nesting MLMCManager rejects: the dp shard_map
            # cannot wrap SpatialDarcy's own device mesh.
            raise ValueError(
                "manager-level sample sharding (SampleMesh) cannot nest "
                "around darcy_solver.spatial_shards; use "
                "spatial_sample_shards for a composed (dp, sp) mesh and "
                "pass sharding=None"
            )
        self.nlevels = int(nlevels if nlevels is not None else problem.nlevels)
        self.batch = int(batch_size if batch_size is not None else config.batch_size)
        if sharding is not None:
            self.batch = sharding.round_batch(self.batch)
        # Per-level batch sizes (finest first; cf. MLMCManager.level_batch:
        # the finest level is bound by device memory at SPE10 scale).
        self.level_batch = [self.batch] * self.nlevels
        bpl = getattr(config, "batch_size_per_level", None)
        if bpl:
            if len(bpl) != self.nlevels:
                raise ValueError(
                    f"batch_size_per_level has {len(bpl)} entries for "
                    f"{self.nlevels} levels"
                )
            self.level_batch = [int(b) for b in bpl]
            if sharding is not None:
                self.level_batch = [
                    sharding.round_batch(b) for b in self.level_batch
                ]
        self.eps2 = float(config.mse)
        self.auto_eps2 = self.eps2 < 0
        if self.auto_eps2:
            self.eps2 = 1.0
        self.ratio = float(config.mse_splitting_ratio)
        self.init_nsamples = int(config.initial_samples)
        self.use_walltime_cost = config.cost_model == "walltime"
        self.verbose = config.verbose

        n = self.nlevels
        self.sums = np.zeros((n, NVAR))
        self.level_nsamples = np.zeros(n, dtype=np.int64)
        self.level_nsamples_missing = np.zeros(n, dtype=np.int64)
        self.M = np.array(
            [problem.solver.num_dofs(l) for l in range(n)], dtype=np.float64
        )
        self.E = np.zeros((n, NVAR))
        self.varYR = np.zeros(n)
        self.varYZ = np.zeros(n)
        self.varYRatio = np.zeros(n)
        self.cost = np.zeros(n)
        self.ml_estimator_variance = math.inf
        self.expected_discretization_error2 = math.inf
        self.actual_mse = math.inf
        # Steady-state walltime ledger (first batch per level excluded -
        # program load must not enter C_l; see uq/managers.py).
        from parelagmc_tpu.utils.timing import SteadyCostLedger

        self._cost_ledger = SteadyCostLedger(n)

        self._key = jax.random.PRNGKey(config.seed + 101)
        self._counter = 0
        self._steps: Dict[int, Callable] = {}
        self._compiled: set = set()
        self._logger = None
        if config.output_filename:
            self._logger = open(config.output_filename, "w")
            self._logger.write(
                "%13s %14s %14s %14s %14s %14s\n"
                % ("%level", "R(xi)", "Y_R(xi)", "Z(xi)", "Y_Z(xi)", "c")
            )

    # -- jitted level steps -----------------------------------------------------
    def _step(self, level: int) -> Callable:
        if level in self._steps:
            return self._steps[level]
        prob = self.problem
        prior = prob.prior
        batch = self.level_batch[level]
        if self.sharding is not None:
            batch = batch // self.sharding.n_devices
        coarsest = level == self.nlevels - 1

        if coarsest:

            def step(key):
                kz, kr = jax.random.split(key)
                zxi = prior.sample(level, kz, batch)
                xi = prior.sample(level, kr, batch)
                z, _ = prob.likelihood(level, prior.eval(level, zxi))
                r, _ = prob.compute_R(level, prior.eval(level, xi))
                zero = jnp.zeros_like(z)
                return r, zero, z, zero  # r, rc, z, zc

        else:

            def eval_coupled(xi):
                # Warm-started coupled prior fields where the sampler has
                # them (cf. MLMCManager._step).
                if hasattr(prior, "eval_pair"):
                    return prior.eval_pair(level, xi)
                return (
                    prior.eval(level, xi),
                    prior.eval(level + 1, xi, xi_level=level),
                )

            split = getattr(self.config, "split_pair_programs", False)
            if split:
                # Run the Z (likelihood) and R streams as two bounded
                # device programs (config.split_pair_programs). Same RNG
                # stream as the composed step.
                from parelagmc_tpu.ops.jit_utils import jit_hoisted

                def z_stream(key):
                    kz, _ = jax.random.split(key)
                    zxi = prior.sample(level, kz, batch)
                    kz_f, kz_c = eval_coupled(zxi)
                    z, _ = prob.likelihood(level, kz_f)
                    zc, _ = prob.likelihood(level + 1, kz_c)
                    return z, zc

                def r_stream(key):
                    _, kr = jax.random.split(key)
                    xi = prior.sample(level, kr, batch)
                    kr_f, kr_c = eval_coupled(xi)
                    r, _ = prob.compute_R(level, kr_f)
                    rc, _ = prob.compute_R(level + 1, kr_c)
                    return r, rc

                if self.sharding is not None:
                    # Each stream is key-driven, so the sharded variant is
                    # just shard_step around it: the per-shard key fold
                    # happens first, then the stream's own split(key) -
                    # identical RNG to the composed sharded step.
                    z_stream = self.sharding.shard_step(z_stream)
                    r_stream = self.sharding.shard_step(r_stream)
                jz = jit_hoisted(z_stream, self._key)
                jr = jit_hoisted(r_stream, self._key)

                def step(key):
                    z, zc = jz(key)
                    r, rc = jr(key)
                    return r, rc, z, zc

                def aot_compile():
                    jz.aot_compile()
                    jr.aot_compile()

                step.aot_compile = aot_compile
                self._steps[level] = step
                return step

            def step(key):
                kz, kr = jax.random.split(key)
                zxi = prior.sample(level, kz, batch)
                xi = prior.sample(level, kr, batch)
                kz_f, kz_c = eval_coupled(zxi)
                kr_f, kr_c = eval_coupled(xi)
                z, _ = prob.likelihood(level, kz_f)
                zc, _ = prob.likelihood(level + 1, kz_c)
                r, _ = prob.compute_R(level, kr_f)
                rc, _ = prob.compute_R(level + 1, kr_c)
                return r, rc, z, zc

        if self.sharding is not None:
            step = self.sharding.shard_step(step)

        from parelagmc_tpu.ops.jit_utils import jit_hoisted

        self._steps[level] = jit_hoisted(step, self._key)
        return self._steps[level]

    def _next_key(self, level: int):
        self._counter += 1
        return jax.random.fold_in(jax.random.fold_in(self._key, level), self._counter)

    # -- sampling rounds ----------------------------------------------------------
    def init_run(self, nsamples: List[int]) -> None:
        if self.problem.G_obs is None:
            self.problem.generate_observational_data()
        for level in range(self.nlevels - 1, -1, -1):
            n = int(nsamples[level])
            if n <= 0:
                continue
            nbatches = -(-n // self.level_batch[level])
            step = self._step(level)
            timer_name = f"Ratio MC Sample -- Level {level}"
            if level not in self._compiled:
                step.aot_compile()  # compiles with a dummy key; no RNG counter used
                self._compiled.add(level)
            if (
                self.use_walltime_cost
                and nbatches == 1
                and level not in self._cost_ledger._seen_this_process
            ):
                # Discarded warmup batch so the single real batch becomes a
                # steady-state cost sample (see uq/managers.py; out-of-band
                # key, statistics and PRNG counter untouched).
                import time as _time

                t0 = _time.perf_counter()
                jax.block_until_ready(
                    step(jax.random.fold_in(self._key, 2 ** 31 - 1 - level))
                )
                self._cost_ledger.add_batch(
                    level, _time.perf_counter() - t0, self.level_batch[level]
                )
            coarsest = level == self.nlevels - 1
            for _ in range(nbatches):
                key = self._next_key(level)
                with TimeManager.timed(timer_name):
                    r, rc, z, zc = jax.block_until_ready(step(key))
                self._cost_ledger.add_batch(
                    level, TimeManager.last(timer_name), int(np.asarray(r).size)
                )
                r = np.asarray(r, dtype=np.float64)
                rc = np.asarray(rc, dtype=np.float64)
                z = np.asarray(z, dtype=np.float64)
                zc = np.asarray(zc, dtype=np.float64)
                y_r = r - rc
                y_z = z - zc
                with np.errstate(divide="ignore", invalid="ignore"):
                    rat = np.where(z != 0, r / np.where(z == 0, 1.0, z), 0.0)
                    rat_c = np.where(zc != 0, rc / np.where(zc == 0, 1.0, zc), 0.0)
                y_ratio = rat if coarsest else rat - rat_c
                # cost in dofs: 2 solves per level of the pair.
                cdofs = 2.0 * self.M[level] + (
                    0.0 if coarsest else 2.0 * self.M[level + 1]
                )
                s = self.sums[level]
                s[YR] += y_r.sum(); s[YR2] += (y_r ** 2).sum(); s[ABS_YR] += np.abs(y_r).sum()
                s[YZ] += y_z.sum(); s[YZ2] += (y_z ** 2).sum(); s[ABS_YZ] += np.abs(y_z).sum()
                s[R] += r.sum(); s[R2] += (r ** 2).sum(); s[ABS_R] += np.abs(r).sum()
                s[Z] += z.sum(); s[Z2] += (z ** 2).sum(); s[ABS_Z] += np.abs(z).sum()
                s[RATIO] += rat.sum(); s[RATIO2] += (rat ** 2).sum(); s[ABS_RATIO] += np.abs(rat).sum()
                s[YRATIO] += y_ratio.sum(); s[YRATIO2] += (y_ratio ** 2).sum(); s[ABS_YRATIO] += np.abs(y_ratio).sum()
                s[C] += cdofs * r.size
                self.level_nsamples[level] += r.size
                if self._logger is not None:
                    for i in range(r.size):
                        self._logger.write(
                            "%13d %14.6g %14.6g %14.6g %14.6g %14.6g\n"
                            % (level, r[i], y_r[i], z[i], y_z[i], cdofs)
                        )
        if self._logger is not None:
            self._logger.flush()
        self.compute_nsamples_mse()

    def run(self) -> float:
        self.sums[:] = 0.0
        self.level_nsamples[:] = 0
        self.level_nsamples_missing[:] = 0
        self.init_run([self.init_nsamples] * self.nlevels)
        self._adaptive_loop()
        if self.verbose:
            print(self.show_me())
        return self.estimate

    def _adaptive_loop(self) -> None:
        """Grow per-level batches toward the missing-samples target until
        the ML estimator variance meets ratio * eps^2. Shared by run() and
        resume() so checkpointed runs follow the identical schedule
        (review r3)."""
        grain = [0] * self.nlevels
        while self.ml_estimator_variance > self.ratio * self.eps2:
            for l in range(self.nlevels):
                grain[l] = min(
                    int(self.level_nsamples_missing[l]),
                    self.init_nsamples + grain[l]
                    + int(self.level_nsamples_missing[l]) // 10,
                )
            self.init_run(grain)

    @property
    def estimate(self) -> float:
        if self.splitting:
            return float(self.E[:, YRATIO].sum())
        denom = self.E[:, YZ].sum()
        return float(self.E[:, YR].sum() / denom) if denom != 0 else math.inf

    # -- estimator mathematics -----------------------------------------------------
    def compute_nsamples_mse(self) -> None:
        n = self.level_nsamples.astype(np.float64)
        taken = n > 0
        nn = np.where(taken, n, 1.0)
        self.E = self.sums / nn[:, None]
        corr = np.where(n > 1, nn / np.maximum(nn - 1.0, 1.0), 1.0)

        def var(col2, col):
            return np.maximum((self.E[:, col2] - self.E[:, col] ** 2) * corr, 0.0)

        self.varYR = var(YR2, YR)
        self.varYZ = var(YZ2, YZ)
        self.varYRatio = var(YRATIO2, YRATIO)

        if self.use_walltime_cost:
            # Steady-state ledger: first batch per level (program load)
            # excluded; all-inclusive timer is the single-batch fallback.
            for l in range(self.nlevels):
                t = TimeManager.elapsed(f"Ratio MC Sample -- Level {l}")
                self.cost[l] = self._cost_ledger.cost_per_sample(
                    l, t, int(self.level_nsamples[l])
                )
        else:
            self.cost = self.E[:, C].copy()

        self.alpha_R = exp_weighted_regression(self.E[:, YR], self.M, 1)
        self.alphaABS_R = exp_weighted_regression(self.E[:, ABS_YR], self.M, 1)
        self.beta_R = exp_weighted_regression(self.varYR, self.M, 1)
        self.alpha_Z = exp_weighted_regression(self.E[:, YZ], self.M, 1)
        self.alphaABS_Z = exp_weighted_regression(self.E[:, ABS_YZ], self.M, 1)
        self.beta_Z = exp_weighted_regression(self.varYZ, self.M, 1)
        # Cost GROWTH rate, reference raw-slope convention (see
        # uq/managers.py compute_nsamples_mse gamma note).
        self.gamma = -exp_weighted_regression(self.cost, self.M, 0)

        def bias2(eabs, aabs):
            # Positive-rate convention (exp_weighted_regression returns the
            # positive decay rate); exponent signs flipped vs the reference's
            # negative-slope formulas (ML_BayesRatio_Manager.hpp / MLMC math,
            # see uq/managers.py compute_nsamples_mse).
            L = self.nlevels
            if L == 1:
                return 0.0
            m = self.M[0] / self.M[1]
            if L > 3:
                return max(m ** (-2 * aabs) * eabs[1] ** 2, eabs[0] ** 2) / (
                    (m ** (2 * aabs) - 1.0) ** 2
                )
            if L == 3:
                return eabs[0] ** 2 / ((m ** aabs - 1.0) ** 2)
            return eabs[0] ** 2

        self.expected_discretization_error2 = max(
            bias2(self.E[:, ABS_YR], self.alphaABS_R),
            bias2(self.E[:, ABS_YZ], self.alphaABS_Z),
        )
        if self.auto_eps2:
            self.eps2 = self.expected_discretization_error2 / (1.0 - self.ratio)

        if self.splitting:
            self.ml_estimator_variance = float(
                np.sum(np.where(taken, self.varYRatio / nn, np.inf))
            )
            var_for_alloc = [self.varYRatio]
        else:
            v_r = float(np.sum(np.where(taken, self.varYR / nn, np.inf)))
            v_z = float(np.sum(np.where(taken, self.varYZ / nn, np.inf)))
            self.ml_estimator_variance = max(v_r, v_z)
            var_for_alloc = [self.varYR, self.varYZ]
        self.actual_mse = (
            self.expected_discretization_error2 + self.ml_estimator_variance
        )

        missing = np.zeros(self.nlevels)
        cost = np.maximum(self.cost, 1e-300)
        for v in var_for_alloc:
            prop = float(np.sum(np.sqrt(v * cost))) / (self.ratio * self.eps2)
            target = prop * np.sqrt(v / cost)
            missing = np.maximum(missing, np.ceil(target - n))
        self.level_nsamples_missing = np.maximum(missing, 0).astype(np.int64)

    # -- checkpoint / resume ------------------------------------------------------
    # Mirrors MLMCManager.save_state/load_state (uq/managers.py): the full
    # estimator state - 20-column moment sums, sample counts, RNG counter,
    # MSE target, per-level cost timers AND the observational data the
    # likelihoods were computed against - round-trips through one .npz, so
    # an interrupted long Bayesian run resumes bit-exactly with the PRNG
    # stream continuing deterministically. (The reference has no
    # checkpointing; VERDICT r2 item 7.)
    def save_state(self, path: str) -> None:
        cost_elapsed = np.array(
            [
                TimeManager.elapsed(f"Ratio MC Sample -- Level {l}")
                for l in range(self.nlevels)
            ]
        )
        obs = self.problem.G_obs
        np.savez(
            path,
            sums=self.sums,
            level_nsamples=self.level_nsamples,
            level_nsamples_missing=self.level_nsamples_missing,
            counter=self._counter,
            eps2=self.eps2,
            seed=self.config.seed,
            splitting=self.splitting,
            cost_elapsed=cost_elapsed,
            g_obs=(np.asarray(obs) if obs is not None else np.zeros(0)),
            **self._cost_ledger.state(),
        )

    def load_state(self, path: str) -> None:
        data = np.load(path)
        if int(data["seed"]) != int(self.config.seed):
            raise ValueError("checkpoint seed does not match config.seed")
        if bool(data["splitting"]) != self.splitting:
            raise ValueError("checkpoint estimator kind (splitting) differs")
        self.sums = data["sums"]
        self.level_nsamples = data["level_nsamples"]
        self.level_nsamples_missing = data["level_nsamples_missing"]
        self._counter = int(data["counter"])
        self.eps2 = float(data["eps2"])
        if data["g_obs"].size:
            # Same device/dtype cast as every other G_obs assignment
            # (uq/bayes.py) so a resumed run is bit-identical to an
            # uninterrupted one (review r3).
            self.problem.G_obs = jnp.asarray(
                data["g_obs"], dtype=self.problem.dtype
            )
        for l, t in enumerate(data["cost_elapsed"]):
            w = TimeManager.get_watch(f"Ratio MC Sample -- Level {l}")
            w.elapsed = float(t)
        self._cost_ledger.load(data)
        self.compute_nsamples_mse()

    def resume(self, path: str) -> float:
        """Load a checkpoint and continue the adaptive run to the target,
        with the same final verbose report as an uninterrupted run()."""
        self.load_state(path)
        self._adaptive_loop()
        if self.verbose:
            print(self.show_me())
        return self.estimate

    # -- reporting --------------------------------------------------------------------
    def show_me(self) -> str:
        w = 42

        def row(name, val):
            return f"{name:<{w}}{val}"

        def vec(name, v):
            return f"{name:<{w}}" + " ".join(f"{x:.8g}" for x in np.atleast_1d(v))

        kind = "Splitting" if self.splitting else "Ratio"
        sl = "SL" if self.nlevels == 1 else "ML"
        lines = [
            "=" * 79,
            f"{sl}_BayesRatio{'_Splitting' if self.splitting else ''}_Manager Errors:",
            "-" * 79,
            row("R Estimate", f"{self.E[:, YR].sum():.8g}"),
            row("Z Estimate", f"{self.E[:, YZ].sum():.8g}"),
            row(f"{kind} Estimate", f"{self.estimate:.8g}"),
            row("Target MSE", f"{self.eps2:.8g}"),
            row("Actual MSE", f"{self.actual_mse:.8g}"),
            row("ML Estimator Variance", f"{self.ml_estimator_variance:.8g}"),
            row("Estimator Bias (Max of R,Z)", f"{self.expected_discretization_error2:.8g}"),
            vec("DOFS in Forward Problem", self.M),
            vec("Cost", self.cost),
            vec("NumSamples", self.level_nsamples),
            vec("E[R]", self.E[:, R]),
            vec("Var[Y_R]", self.varYR),
            vec("E[Y_R]", self.E[:, YR]),
            vec("E[Z]", self.E[:, Z]),
            vec("Var[Y_Z]", self.varYZ),
            vec("E[Y_Z]", self.E[:, YZ]),
            vec("E[Ratio]", self.E[:, RATIO]),
            vec("E[Y_Ratio]", self.E[:, YRATIO]),
            vec("Var[Y_Ratio]", self.varYRatio),
            "=" * 79,
        ]
        return "\n".join(lines)

    def close(self) -> None:
        if self._logger is not None:
            self._logger.close()
            self._logger = None


class SLBayesRatioManager(BayesRatioManager):
    """Single-level ratio estimator (reference SL_BayesRatio_Manager.hpp)."""

    def __init__(self, problem, config, splitting=False, batch_size=None, sharding=None):
        super().__init__(
            problem,
            config,
            nlevels=1,
            splitting=splitting,
            batch_size=batch_size,
            sharding=sharding,
        )
