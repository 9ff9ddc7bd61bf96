"""Test configuration: JAX on the CPU, as a virtual 8-device mesh so the
sharding paths run without accelerators (SURVEY.md §4 implication).

An explicit JAX_PLATFORMS wins: the gpu-marked tests run on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
