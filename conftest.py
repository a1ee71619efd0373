"""Root conftest: force the test session onto a virtual 8-device CPU mesh.

The platform is pinned through jax.config before any backend is
initialized, so the tests run on the CPU whatever accelerator the machine
has. Multi-device sharding tests run on the forced 8-device CPU backend
(``--xla_force_host_platform_device_count=8``), the fake-backend story the
CUDA reference lacks entirely (SURVEY.md §4). Tests of code that runs only
on the GPU carry the ``gpu`` marker, take the ``gpu`` fixture and skip here;
``python chip_smoke.py`` runs the same checks on the card.
"""

import os
import sys

# Must be set before the CPU backend is created.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
