"""Test configuration: run JAX on a simulated 8-device CPU mesh.

The tests run on the CPU backend; sharding/mesh code is validated on 8
virtual CPU devices per SURVEY.md §4's test strategy. The device smoke test
is ``python chip_smoke.py`` on the card.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu", "tests must run on simulated CPU devices"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for mesh tests"


@pytest.fixture
def b3db():
    """Skip unless the B3DB TSVs are present (``BBBP_B3DB_DIR``)."""
    from bbbp.data.b3db import B3DB_CLASSIFICATION_TSV, B3DB_REGRESSION_TSV

    for path in (B3DB_CLASSIFICATION_TSV, B3DB_REGRESSION_TSV):
        if not os.path.exists(path):
            pytest.skip(f"B3DB TSV not found at {path}; set BBBP_B3DB_DIR")
