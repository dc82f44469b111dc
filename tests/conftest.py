"""Test harness configuration.

Tests run on the CPU, on an 8-device virtual CPU mesh: ``JAX_PLATFORMS=cpu
python -m pytest tests/`` (the reference's tests require a real GPU +
OpenCV-CUDA; our oracles are OpenCV CPU — ``cv2`` — per SURVEY.md §4, and
the plain numpy reference of ``chip_smoke.py``, with the same tolerance
contract: integer outputs bit-exact, float outputs per-pixel
|diff| <= 1e-4). The multi-device sharding tests use the 8 virtual devices.
``chip_smoke.py`` (not the test suite) runs the same paths on the GPU.
"""

import os
import sys

# Must be set before the CPU client initializes.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

# the repository root, for ``chip_smoke``'s numpy reference
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


# Tolerance contract (reference tests/testsCommon.cuh:36-61).
FLOAT_TOL = 1e-4


def check_exact(actual, expected, msg=""):
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, f"{msg} shape {actual.shape} vs {expected.shape}"
    diff = (actual.astype(np.int64) != expected.astype(np.int64)).sum()
    assert diff == 0, f"{msg}: {diff} mismatching pixels (integer outputs must be bit-exact)"


def assert_backend(expected):
    """Assert the lowering the last ``execute_operations`` /
    ``launch_divergent_batch`` call used."""
    from cvgpuspeedup_tpu.exec import executor

    got = executor.last_backend()
    assert got == expected, f"lowering {got!r}, expected {expected!r}"


def check_float(actual, expected, tol=FLOAT_TOL, msg=""):
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    assert actual.shape == expected.shape, f"{msg} shape {actual.shape} vs {expected.shape}"
    bad = np.abs(actual - expected) > tol
    assert not bad.any(), (
        f"{msg}: {bad.sum()} pixels exceed |diff|<= {tol}; "
        f"max diff {np.abs(actual - expected).max()}"
    )
