"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, which also
covers the mesh/shard_map paths without hardware; Pallas kernels run in
interpret mode.  Tests marked ``gpu`` need a card and skip elsewhere; run
them on a GPU host with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.  Must run before any jax backend use.
"""

import os

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from tpuzlib import corpus


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU; skips elsewhere")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")


@pytest.fixture(scope="session")
def paradiselost():
    return corpus.artifact("paradiselost.txt")


@pytest.fixture(scope="session")
def simple_txt():
    return corpus.artifact("simple.txt")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
