import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy
from parelagmc_tpu.mesh import make_box_mesh
from parelagmc_tpu.parallel import SampleMesh
from parelagmc_tpu.physics import DarcySolver
from parelagmc_tpu.samplers import SPDESampler
from parelagmc_tpu.uq import MLMCManager
from parelagmc_tpu.utils.timing import TimeManager

DT = jnp.float64


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8  # conftest forces the virtual CPU mesh


def test_shard_step_outputs_global_batch():
    sm = SampleMesh()
    assert sm.n_devices == 8
    assert sm.round_batch(9) == 16

    def local_step(key):
        x = jax.random.normal(key, (4,))
        return x, x * 2.0

    step = jax.jit(sm.shard_step(local_step))
    a, b = step(jax.random.PRNGKey(0))
    assert a.shape == (32,)
    np.testing.assert_allclose(np.asarray(b), 2 * np.asarray(a))
    # Shards saw distinct keys -> distinct draws.
    chunks = np.asarray(a).reshape(8, 4)
    assert np.unique(chunks.round(6), axis=0).shape[0] == 8


def test_sharded_mlmc_manager(tmp_path):
    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 2)
    cfg = ProblemConfig(
        refinements=1, mse=1e10, batch_size=12, initial_samples=24,
        output_filename=str(tmp_path / "shard.dat"),
    )
    sampler = SPDESampler(hier, cfg, DT)
    solver = DarcySolver(hier, cfg, DT)
    sm = SampleMesh()
    mgr = MLMCManager(solver, sampler, cfg, sharding=sm)
    assert mgr.batch == 16  # rounded to the device count
    mgr.init_run([24, 24])
    assert int(mgr.level_nsamples[0]) == 32  # 2 batches of 16
    # Statistics are physical.
    assert 1.0 < mgr.eQ[1] < 5.0
    assert np.all(mgr.consistency[:1] < 1.0)
    mgr.close()


def test_sharded_matches_unsharded_statistics(tmp_path):
    # Same law: sharded and unsharded runs agree within MC error.
    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 1)
    cfg = ProblemConfig(refinements=0, mse=1e10, batch_size=64,
                        initial_samples=256, output_filename="")
    sampler = SPDESampler(hier, cfg, DT)
    solver = DarcySolver(hier, cfg, DT)
    m1 = MLMCManager(solver, sampler, cfg, nlevels=1)
    m1.init_run([256])
    m2 = MLMCManager(solver, sampler, cfg, nlevels=1, sharding=SampleMesh())
    m2.init_run([256])
    se = np.sqrt(m1.varQ[0] / 256 + m2.varQ[0] / 256)
    assert abs(m1.eQ[0] - m2.eQ[0]) < 5 * se


def test_sharded_split_pair_matches_composed(tmp_path):
    """split_pair_programs composes with sample sharding (r3): the sharded
    split pair step folds the same per-shard key and threads the same warm
    start as the composed sharded step, so level statistics agree to
    solver tolerance (XLA fuses differently across program boundaries)."""
    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 2)
    results = []
    for split in (False, True):
        cfg = ProblemConfig(
            refinements=1, mse=1e10, batch_size=16, initial_samples=16,
            output_filename="", seed=5, split_pair_programs=split,
        )
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        mgr = MLMCManager(solver, sampler, cfg, sharding=SampleMesh())
        mgr.init_run([16, 16])
        results.append((mgr.eY.copy(), mgr.eQ.copy(), mgr.varY.copy()))
        mgr.close()
    for a, b in zip(results[0], results[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_sharded_split_segments_continue(tmp_path):
    """Sharded split pair step with bounded per-program iteration budgets:
    both pair members continue across solve_segments on every shard (the
    host-side convergence check reduces over the GLOBAL batch, so all
    shards take the same continuation branch). Statistics match a deep
    composed sharded reference to Krylov tolerance (cf. the unsharded
    test_managers.test_split_pair_coarse_member_continues)."""
    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 2)

    def run(split):
        cfg = ProblemConfig(
            refinements=1, mse=1e10, batch_size=16, initial_samples=16,
            output_filename="", seed=9, split_pair_programs=split,
            solve_segments=12 if split else 1,
        )
        if split:
            cfg.darcy_solver.max_iterations = 10
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        mgr = MLMCManager(solver, sampler, cfg, sharding=SampleMesh())
        mgr.init_run([16, 16])
        out = (mgr.eY.copy(), mgr.eQ.copy())
        mgr.close()
        return out

    for a, b in zip(run(False), run(True)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-8)


@pytest.mark.parametrize("sharded", [False, True])
def test_split_step_compiles_each_program_once(sharded):
    """aot_compile builds the very programs the split pair step runs: the
    stage-2 examples carry the 'dp' sharding the handoff arrays arrive
    with, so the first call compiles nothing more."""
    import logging

    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 2)
    cfg = ProblemConfig(
        refinements=1, mse=1e10, batch_size=16, initial_samples=16,
        output_filename="", seed=5, split_pair_programs=True,
    )
    sampler = SPDESampler(hier, cfg, DT)
    solver = DarcySolver(hier, cfg, DT)
    mgr = MLMCManager(solver, sampler, cfg,
                      sharding=SampleMesh() if sharded else None)
    compiles = []

    class Count(logging.Handler):
        def emit(self, record):
            if "Finished XLA compilation of jit(pure)" in record.getMessage():
                compiles.append(record)

    handler = Count()
    logger = logging.getLogger("jax._src.dispatch")
    logger.addHandler(handler)
    try:
        with jax.log_compiles():
            step = mgr._step(0)
            step.aot_compile()
            n_aot = len(compiles)
            jax.block_until_ready(step(jax.random.PRNGKey(3)))
    finally:
        logger.removeHandler(handler)
    assert n_aot == 2  # stage 1 and stage 2 (one segment: no continuations)
    assert len(compiles) == n_aot
    mgr.close()


def test_sample_shards_config_surface(tmp_path):
    """config.sample_shards (the --sample-shards CLI flag) makes every
    manager build its own 'dp' SampleMesh: -1 = all visible devices; the
    statistics match an explicitly-sharded manager exactly (same mesh,
    same per-shard key folds)."""
    TimeManager.reset()
    mesh = make_box_mesh((2, 2, 2), lengths=(2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(mesh, 2)

    def run(sample_shards, sharding):
        cfg = ProblemConfig(
            refinements=1, mse=1e10, batch_size=16, initial_samples=16,
            output_filename="", seed=3, sample_shards=sample_shards,
        )
        sampler = SPDESampler(hier, cfg, DT)
        solver = DarcySolver(hier, cfg, DT)
        mgr = MLMCManager(solver, sampler, cfg, sharding=sharding)
        assert (mgr.sharding is not None) == (
            sample_shards == -1 or sharding is not None
        )
        if mgr.sharding is not None:
            assert mgr.sharding.n_devices == 8
        mgr.init_run([16, 16])
        out = (mgr.eY.copy(), mgr.eQ.copy())
        mgr.close()
        return out

    a = run(-1, None)           # config-driven mesh
    b = run(0, SampleMesh())    # explicit mesh
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-14)

    # Guard: sample sharding cannot nest around spatial decomposition.
    cfg = ProblemConfig(
        refinements=1, mse=1e10, batch_size=16, output_filename="",
        sample_shards=-1,
    )
    cfg.darcy_solver.spatial_shards = 2
    sampler = SPDESampler(hier, cfg, DT)
    solver = DarcySolver(hier, cfg, DT)
    with pytest.raises(ValueError, match="spatial_shards"):
        MLMCManager(solver, sampler, cfg)

    # Too many shards for the visible devices is an explicit error.
    cfg2 = ProblemConfig(
        refinements=1, mse=1e10, batch_size=16, output_filename="",
        sample_shards=16,
    )
    sampler2 = SPDESampler(hier, cfg2, DT)
    solver2 = DarcySolver(hier, cfg2, DT)
    with pytest.raises(ValueError, match="sample_shards"):
        MLMCManager(solver2, sampler2, cfg2)
