"""Test harness: force JAX onto CPU with 8 virtual devices so sharding tests
run without GPUs (SURVEY.md sect.4 implication (d)). The platform is pinned
in jax.config after import, before any backend is used, so the tests run on
the CPU whatever JAX_PLATFORMS says. Tests marked `chip` need a GPU: they
take the `gpu` fixture, which skips here (chip_smoke.py runs their bodies
on the card)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
    assert jax.device_count() == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(7)


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU (decided per test, never at
    import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py there")
