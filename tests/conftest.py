"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
logic is exercised without GPUs.  JAX_PLATFORMS picks the backend when it
is set: tests marked `gpu` run on the card with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu` and skip elsewhere.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session")
def data_dir() -> str:
    return DATA_DIR
