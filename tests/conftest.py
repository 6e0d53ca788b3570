"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the multi-device
sharding paths are validated without a GPU, and f64 is IEEE binary64
everywhere. This must happen before JAX initializes any backend.

Tests marked `gpu` need a card and skip here. On a machine with one, run
them with:  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Persistent compilation cache: the XLA:CPU softfloat (e64) graphs take
# minutes to compile; caching makes repeated RUN_SLOW runs pay that once
# per code change.
from nbody.backend import enable_persistent_compile_cache  # noqa: E402

enable_persistent_compile_cache()

sys.path.insert(0, os.path.dirname(__file__))

TESTCASE_DIR = "/root/reference/testcases"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "golden: full-length golden testcase runs (slow; opt in "
        "with RUN_GOLDEN=1)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (see the module "
        "docstring of tests/conftest.py)")


@pytest.fixture
def gpu():
    """The first GPU, or a skip when the process has none. Decided here,
    at test time, so every worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ on a machine with one")
    return devices[0]
