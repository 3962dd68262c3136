"""Test configuration: JAX on a virtual 8-device CPU mesh.

Tests run on the CPU with 8 virtual devices so multi-card sharding paths
are exercised without real hardware (mirrors how the reference tests
multi-node behavior on localhost — SURVEY.md §4). ``JAX_PLATFORMS`` picks
the platforms when it is set: ``JAX_PLATFORMS=cuda,cpu`` runs the
``gpu``-marked tests on the card (README, Tests); unset, it is the CPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest

from rad_tpu.fp import random_fingerprints


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the full lane including @pytest.mark.slow tests "
             "(16/32-device dryruns, multihost two-process tests, "
             "billion-scale shape checks). Default lane skips them so a "
             "dev-loop `pytest -q` stays fast; CI runs both lanes.")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--full") or os.environ.get("RAD_TPU_FULL_TESTS"):
        return
    if "slow" in (config.getoption("-m") or ""):
        return  # explicit -m slow / -m 'not slow' selection wins
    skip = pytest.mark.skip(reason="slow lane: pass --full (or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU, or skip: for tests of code that runs only on the
    card (a Triton kernel compiled for it has no CPU form)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the "
                    "card)")
    return dev


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu"
    return devs


@pytest.fixture(scope="session")
def small_fps():
    """64-bit, 200-vector fingerprint set (reference test scale:
    tests/test_hnsw_service.py:13-28 uses dim 64, 20-1000 vectors)."""
    return random_fingerprints(200, n_bits=64, density=0.3, seed=42)


@pytest.fixture(scope="session")
def medium_fps():
    """1024-bit, 1000-vector fingerprint set (reference canonical dim)."""
    return random_fingerprints(1000, n_bits=1024, density=0.1, seed=7)
