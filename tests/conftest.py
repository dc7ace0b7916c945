"""Test configuration: CPU JAX with a virtual 8-device mesh by default.

Mirrors the reference CI (CPU-only, see reference ``SURVEY.md`` section 4)
while letting sharding tests exercise a multi-device mesh. Tests marked
``gpu`` need a card and skip elsewhere; run them on one with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Hold JAX to the platforms JAX_PLATFORMS names (the CPU unless set), even
# where an accelerator plugin is installed.
import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never while modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
