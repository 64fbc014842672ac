"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The reference renderer's only machine-checked signal was fail-fast CUDA error
macros (reference cutil.h:24-52); it had no tests at all (SURVEY.md §4). This
suite is the testing pyramid the reference lacked. Sharding tests use JAX's
standard fake-backend trick: 8 virtual CPU devices, so `shard_map`/`pjit`
paths are exercised without accelerators.

Tests that need an NVIDIA GPU live in tests/test_gpu.py, carry the `gpu`
marker and skip here; `python chip_smoke.py` runs them on the card.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
# No persistent compile cache for the CPU suite: deserializing cached CPU
# executables has aborted the whole test process.

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the number of live XLA:CPU executables across the suite.

    A full-suite run has segfaulted inside backend_compile_and_load late in
    the run while the identical tail passes in a fresh process — a
    cumulative process-state problem in XLA:CPU executable management.
    Dropping compiled-function caches between modules keeps the
    live-executable count bounded.
    """
    yield
    jax.clear_caches()
