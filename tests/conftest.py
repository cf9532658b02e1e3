"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs with ``JAX_PLATFORMS=cpu``; the default device is pinned to
the CPU as well, and 8 virtual CPU devices serve the sharding tests.  No
test needs a GPU: GPU execution is exercised by chip_smoke.py and bench.py.

x64 is enabled because the kernel parity tests compare against float64 NumPy
brute force (the reference's CPU trees are double precision); production
paths use explicit float32/bfloat16 dtypes.
"""

import os

# Must happen before jax initializes its backends.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np
import pytest


def cpu_devices(n=8):
    return jax.devices("cpu")[:n]


@pytest.fixture
def rng():
    return np.random.default_rng(20170717)
