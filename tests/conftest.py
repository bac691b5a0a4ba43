"""Test harness: the tests run on the CPU (`JAX_PLATFORMS=cpu`), with 8
virtual CPU devices for the sharding tests.

Mirrors SURVEY.md §4's implication: the reference has no unit tests, so we
build the pyramid ourselves — kernel unit tests against closed forms
(Pallas kernels in interpret mode), module tests on synthetic scenes, and
sharding tests emulated on virtual CPU devices.

Tests marked `gpu` need the card and skip elsewhere; `chip_smoke.py`
runs the same checks on the GPU.
"""

import os

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")  # silence XLA AOT-loader spam

import jax

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache: repeated test runs reuse executables.
from orbslam3_jax.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
