"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here —
tests run on the 1-device CPU world; only launch/dryrun.py (subprocess)
uses 512 placeholder devices."""
from __future__ import annotations

import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips itself without CUDA")
