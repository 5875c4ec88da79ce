"""Test configuration: JAX runs on a virtual 8-device CPU mesh, so the
multi-device sharding paths are exercised without a card
(``__graft_entry__.py`` rehearses the multi-device programs the same way).

Tests that need the card carry the ``gpu`` marker and skip here; on a
machine with the card run them with ``FLUTPU_GPU_TESTS=1 python -m pytest
tests/ -m gpu`` (see README.md).
"""

import os
import sys

if not os.environ.get("FLUTPU_GPU_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("FLUTPU_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from flutpu.platform import enable_compile_cache  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long sharded/mesh tests (>15 s each) — excluded from the "
        "default run; enable with FLUTPU_FULL_TESTS=1 or -m slow")
    config.addinivalue_line(
        "markers",
        "gpu: needs the card (an NVIDIA GPU); skips elsewhere — run with "
        "FLUTPU_GPU_TESTS=1 python -m pytest tests/ -m gpu")


def pytest_collection_modifyitems(config, items):
    """Default `pytest -q` skips @slow (a handful of 18-41 s sharded
    FVC/adaptive-grow/multihost tests); the FULL suite still runs via
    FLUTPU_FULL_TESTS=1."""
    if os.environ.get("FLUTPU_FULL_TESTS"):
        return
    if config.getoption("-m"):
        return  # explicit marker selection wins
    skip = pytest.mark.skip(
        reason="slow suite: set FLUTPU_FULL_TESTS=1 (or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX finds the card. Decided
    here, per test, never while a module is imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the card: no GPU in this process")


# Persistent XLA compile cache: the suite is compile-dominated, and cached
# recompiles cut repeat runs. Keyed on HLO hash, so stale-cache
# correctness is jax's contract.
try:
    enable_compile_cache(min_compile_secs=0.5)
except Exception:
    pass
