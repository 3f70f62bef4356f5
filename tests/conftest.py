"""Test configuration: CPU backend with 8 virtual devices + float64.

Tests run on CPU with an 8-device virtual mesh so the shard_map paths are
exercised exactly as ``__graft_entry__.dryrun_multichip`` does, and with
x64 enabled so the ``double`` precision policy reproduces the reference's
complex128 numerics.  Tests that need an NVIDIA GPU take the ``gpu``
fixture below (marker ``gpu``); it skips them here, deciding at run time,
never at import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none (as in this
    CPU-pinned test process).  Card-only tests are marked ``gpu`` and run
    on a GPU machine with ``python -m pytest -m gpu tests/``."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; none visible to JAX here")
    return devs[0]


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8, jax.devices()
