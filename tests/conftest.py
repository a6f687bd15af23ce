"""Test environment: CPU backend with 8 virtual devices, fp64 enabled.

This is the standard JAX recipe for testing pjit/psum/mesh logic without a
cluster (SURVEY.md §4d): `xla_force_host_platform_device_count=8` gives
eight fake CPU devices, so every sharding test exercises the real SPMD
partitioner and collectives.  fp64 is enabled globally for parity tests
against the C++ oracle (the reference is all-double).

Tests marked ``gpu`` need a CUDA card and skip elsewhere (decided inside
the ``gpu`` fixture, never at import).  chip_smoke.py runs them in its own
process after JAX has initialized the GPU; a backend that is already
initialized is left as it is.
"""
import os

from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    # Must be set before the backend initializes.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a CUDA GPU: the Triton kernels
    compile only for the card (their interpret-mode twins run everywhere)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX's first device is {dev.platform}")
    return dev
