"""Test harness: force JAX onto a virtual 8-device CPU mesh.

Mirrors the reference CI's threads-{1,2,16} matrix role (SURVEY §4):
results must be invariant under device-count / sharding choices, so
tests run on 8 virtual CPU devices and sharded paths are exercised
against single-device results.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import pathlib

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

REFERENCE_ROOT = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_test_dir():
    d = REFERENCE_ROOT / "test"
    if not d.exists():
        pytest.skip("reference test fixtures not available")
    return d
