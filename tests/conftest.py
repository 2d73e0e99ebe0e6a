"""Test configuration: force JAX onto CPU with 8 virtual devices.

Multi-device tests (ensemble axis, bead sharding, halo exchange) run on a
simulated 8-device CPU mesh, per SURVEY.md §4. Must run before jax imports.
"""

import os

# Force-set (not setdefault): unit tests run on the virtual 8-device CPU
# mesh even on a machine with a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
