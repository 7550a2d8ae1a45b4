"""Test configuration: run everything on a virtual 8-device CPU mesh.

The CPU is the device here, so the Pallas kernels run in interpret mode
(ops/backend.py); multi-device sharding is validated on forced host
devices (the pattern __graft_entry__.py's dryrun uses too).  Tests that
need the GPU carry the `gpu` marker and skip here; chip_smoke.py runs
the same checks on the card.  Env vars must be set before jax
initializes.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from soc_real_time_renderer.utils import compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
jax.config.update("jax_platforms", "cpu")
# persistent compile cache: recompiles across test runs are the
# dominant cost on CPU
compile_cache.enable()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (chip_smoke.py runs "
        "the same checks on the card)")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time,
    never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
