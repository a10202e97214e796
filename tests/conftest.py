"""Test environment: host-local multi-device CPU simulation.

The reference tests are one self-verifying binary (`radix_tests.cpp:209-227`).
Here: property tests against numpy oracles on CPU, with an 8-device virtual
mesh (`xla_force_host_platform_device_count`) so the multi-device shuffle is
tested without several cards (SURVEY §4). ``RST_TEST_PLATFORM`` names another
JAX platform to run the suites on (e.g. ``cuda``).

Env vars must be set before jax initializes, hence this conftest.
"""

import os

os.environ["JAX_PLATFORMS"] = os.environ.get("RST_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.Generator(np.random.PCG64(0xC0FFEE))

