"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual host
devices for the sharding tests (SURVEY.md §4: multi-device tests on one
host via virtual devices). XLA_FLAGS must be set before jax initializes
its backends. The platform itself is left to ``JAX_PLATFORMS``: tests
marked ``gpu`` need the card and skip, through the ``gpu_device`` fixture,
wherever JAX finds none.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running tests"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX finds none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python chip_smoke.py)")
    return devs[0]
