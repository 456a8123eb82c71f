"""Test configuration: run everything on CPU with 8 virtual devices.

This is the analog of the reference's `mpirun -np N` on a single box
(reference: CMakeLists.txt:191-196 add_mpi_test): multi-device sharding
code paths are exercised on a virtual device mesh. Verification configs
run in float64 (jax_enable_x64) so FEM oracles can use tight tolerances.

The tests run on the CPU even where a GPU is present:
jax.config.update("jax_platforms", "cpu") works as long as no backend has
been initialized yet, and XLA_FLAGS is honored at (lazy) CPU client
creation. What only the GPU can run is checked by `python chip_smoke.py`
(see README.md).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Example drivers turn on the persistent compilation cache
# (examples/common.parse_config); the tests compile without it.
jax.config.update("jax_enable_compilation_cache", False)


def pytest_collection_modifyitems(config, items):
    """Mark the measured-slow node IDs from tests/slow_tests.txt with
    @pytest.mark.slow so `-m "not slow"` is a mechanical ~15-min fast
    default (round-3 VERDICT item 8; full suite stays the round gate).
    Parametrized tests are matched by their base node ID too, so a new
    parametrization of a slow test stays tagged."""
    import os

    import pytest

    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    if not os.path.exists(path):
        return
    with open(path) as f:
        slow = {
            line.strip() for line in f
            if line.strip() and not line.startswith("#")
        }
    bases = {s.split("[", 1)[0] for s in slow}
    for item in items:
        nid = item.nodeid
        if nid in slow or nid.split("[", 1)[0] in bases:
            item.add_marker(pytest.mark.slow)
