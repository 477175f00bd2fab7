"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU backend, whatever accelerator the machine has:
they check results at small shapes, and the multi-device sharding
paths are validated on host-platform virtual devices, per the
multi-device test strategy SURVEY.md §4 calls for. Tests that need a
GPU carry the ``gpu`` marker and skip without one (tests/test_gpu.py).

The platform is pinned through jax.config (not only the env var) so an
import-time JAX_PLATFORMS setting elsewhere cannot override it.
"""

import os

# Must be set before the JAX backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from aruco_slam_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: the suite is compile-bound, and kernels
# rarely change between runs
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


# The XLA:CPU JIT on long single-process runs segfaults inside
# backend_compile once enough executables have accumulated (observed
# deterministically at the ~95th test's large sharded-BA compile;
# every sub-suite passes in isolation). Dropping the in-process
# executable caches between modules keeps peak JIT state bounded; the
# persistent on-disk cache makes the recompiles cheap.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_state():
    yield
    jax.clear_caches()
