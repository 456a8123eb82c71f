"""Multi-chip sample parallelism.

The framework's main parallel axis is the *sample batch* (SURVEY.md 2.3:
the reference parallelizes spatially over MPI ranks and draws samples
sequentially, src/MLMC_Manager.cpp:113-175; here hundreds of realizations
run per chip and the batch is sharded over the device mesh).

`SampleMesh` wraps a 1D jax.sharding.Mesh over the 'dp' axis and turns a
per-shard level step (key -> per-sample arrays) into a global SPMD program
via shard_map: every device draws its own noise (its shard's key is the
global key folded with the device index - deterministic, device-count-
explicit), runs the full realization pipeline locally (all operators are
replicated constants), and the manager receives globally-batched arrays.
Cross-device moment reductions (jnp.sum over the sharded batch inside a
jitted consumer, or host-side accumulation after gather) lower to ICI
collectives / gathers inserted by XLA (NCCL on GPUs).

Spatial sharding of one realization's dof vector (the analog of the
reference's domain decomposition) lives in parallel/spatial_darcy.py
(SpatialDarcy: the real Darcy Schur solve sharded along the mesh y axis,
built from a DarcySolver level) with the generic-CSR prototype in
parallel/spatial.py; it matters when a single fine level exceeds one
device's memory (SURVEY.md 5.7, e.g. a refined SPE10 finest level). It is
reachable from the config surface
(config.darcy_solver.spatial_shards routes the finest Darcy level through
the sharded solver; spatial_sample_shards composes a 2D (dp, sp) mesh
sharding the batch as well) - note SampleMesh's own dp shard_map cannot
nest around it, so pick ONE of manager-level sample sharding or the
composed (dp, sp) spatial mesh per run.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def sample_mesh_from_config(config) -> Optional["SampleMesh"]:
    """Build the manager-level SampleMesh requested by
    `config.sample_shards` (0/1 = off, -1 = every visible device), or None.

    The single consumption point for the config/CLI surface
    (`--sample-shards` in examples/common.py): every estimator manager
    calls this when no explicit `sharding=` is passed, so multi-chip data
    parallelism is reachable from all drivers without per-driver plumbing.
    """
    n = int(getattr(config, "sample_shards", 0) or 0)
    if n in (0, 1):
        return None
    if n < -1:
        # Without this, e.g. -2 would slip through and devices[:-2] below
        # would silently shard over all-but-two devices (advisor finding r3).
        raise ValueError(
            f"config.sample_shards={n} is invalid (use -1 for all devices)"
        )
    devices = jax.devices()
    if n == -1:
        n = len(devices)
    if n > len(devices):
        raise ValueError(
            f"config.sample_shards={n} but only {len(devices)} device(s) "
            f"are visible"
        )
    return SampleMesh(devices=devices[:n])


class SampleMesh:
    def __init__(self, devices: Optional[Sequence] = None, axis_name: str = "dp"):
        if devices is None:
            devices = jax.devices()
        self.axis_name = axis_name
        self.mesh = Mesh(np.asarray(devices), (axis_name,))

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    def round_batch(self, batch: int) -> int:
        """Smallest multiple of the device count >= batch."""
        n = self.n_devices
        return -(-batch // n) * n

    def shard_step(self, step_local: Callable, out_ndim: int = 1) -> Callable:
        """Lift a per-shard step `key -> pytree of (local_batch, ...) arrays`
        to a global SPMD step `key -> pytree of (global_batch, ...) arrays`.

        Every shard folds its 'dp' index into the key, so the global sample
        stream is deterministic for a fixed device count.
        """
        from jax import shard_map

        axis = self.axis_name

        def wrapped(key):
            idx = jax.lax.axis_index(axis)
            return step_local(jax.random.fold_in(key, idx))

        return shard_map(
            wrapped,
            mesh=self.mesh,
            in_specs=(P(),),
            out_specs=P(axis),
            check_vma=False,
        )

    def shard_stage(self, stage_local: Callable) -> Callable:
        """Lift a continuation stage over already-'dp'-sharded batch arrays
        (pytree of (local_batch, ...) -> pytree of (local_batch, ...)) to
        the global mesh.

        Unlike `shard_step` there is no RNG key to fold: the inputs are a
        previous stage's dp-sharded outputs (the split pair step's
        device-to-device handoff, uq/managers._build_split_step). Every
        output must be batch-led - scalar per-shard results such as Krylov
        iteration counters have to be broadcast to the local batch inside
        `stage_local` before they cross the shard_map boundary.
        """
        from jax import shard_map

        axis = self.axis_name
        return shard_map(
            stage_local,
            mesh=self.mesh,
            in_specs=P(axis),
            out_specs=P(axis),
            check_vma=False,
        )
