"""Test configuration: run on an 8-device virtual CPU mesh.

The tests run on the CPU; sharding logic is validated on virtual CPU
devices (``--xla_force_host_platform_device_count``).  The platform is
pinned through ``jax.config`` as well as ``JAX_PLATFORMS``, so a machine
whose JAX also sees a GPU still runs the suite on the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(2705)
