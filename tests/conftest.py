"""Test configuration: force the CPU backend with 8 virtual devices.

Tests run deterministically without a GPU; multi-chip sharding tests use
the virtual-device mesh (SURVEY.md §4: CPU backend as the 'fake backend' +
--xla_force_host_platform_device_count device simulation).  Pallas kernels
run in interpret mode here (render/platform.py).  Tests that need the card
carry the `gpu` marker and skip through the `gpu` fixture.
"""

import os

if os.environ.get("PIM_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU (decided here,
    at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `PIM_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/test_bvh_kernel.py` on the card "
                    "(chip_smoke.py does)")
    return jax.devices()[0]
