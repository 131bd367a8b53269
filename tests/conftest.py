"""Test configuration: the CPU with 8 virtual devices, unless a GPU is asked for.

With ``JAX_PLATFORMS`` unset or ``cpu`` the tests run on the CPU backend
with 8 virtual devices, so sharding tests run on a virtual 8-device mesh.
Setting the live config as well as the environment makes this hold even
when jax was imported before this file ran.

With ``JAX_PLATFORMS=cuda`` (or ``gpu``) the platform is left alone, and
the tests marked ``gpu`` run on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Elsewhere those tests skip; the ``gpu`` fixture decides, at run time.
"""

import os

import pytest

_GPU_ASKED = any(p in ("cuda", "gpu") for p in os.environ.get("JAX_PLATFORMS", "").split(","))

if not _GPU_ASKED:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _GPU_ASKED:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return jax.devices()[0]
