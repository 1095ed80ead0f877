"""Test env.

The suite runs on the CPU: XLA paths compiled for the CPU, Pallas kernels in
interpret mode.  Tests that need a GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them when JAX finds no GPU; on a machine with
one they run with ``python -m pytest tests/ -m gpu``.

Multi-device tests (tests/test_parallel.py, tests/test_collective.py) run
in a subprocess with JAX_PLATFORMS=cpu and a virtual 8-device host mesh.
The XLA flag is set here so any in-process CPU usage also sees 8 devices.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from clusterfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {devs[0].platform!r}")
    return devs[0]
