"""Test env: force CPU with 8 virtual devices BEFORE jax import.

This is the standard JAX idiom for testing multi-device sharding without a
multi-card machine (SURVEY.md §4.4); runs on the card are `chip_smoke.py`
and the benchmarks.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from readserver_tpu.corpus import simulate  # noqa: E402


@pytest.fixture(scope="session")
def tiny_corpus():
    return simulate.simulate_config("tiny")


@pytest.fixture(scope="session")
def small_corpus():
    return simulate.simulate_config("small")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
