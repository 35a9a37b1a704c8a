"""Test harness config: run on a virtual 8-device CPU mesh.

Sharding is validated on host CPU devices. Tests that need the GPU carry
the ``gpu`` marker and take the ``gpu_device`` fixture, which skips them
unless JAX's default device is a GPU; ``chip_smoke.py`` runs them on the
card. ``JAX_PLATFORMS`` defaults to ``cpu`` here; set it (e.g. ``cuda``)
to run the suite on another platform.
"""

import os

# XLA reads this lazily at first backend init, which hasn't happened yet.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# tests compile small programs once each; no persistent cache between runs
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The GPU the test runs on; skips the test where there is none. Decided
    here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's default device is {dev.platform})")
    return dev
