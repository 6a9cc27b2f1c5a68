"""Test configuration: force JAX onto the CPU with 8 virtual devices, so the
sharding paths run quickly without an accelerator. Tests that need the GPU
carry the `gpu` marker and skip here (see `gpu_only` below).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU. Decided inside the fixture
    (never at import or collection time, so every xdist worker collects the
    same tests). The GPU lane runs with JAX_PLATFORMS=cuda."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda pytest -m gpu tests/)")
