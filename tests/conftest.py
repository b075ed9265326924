"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Entropy/T2/host paths need no accelerator; jnp transforms run fine on CPU;
the multi-device sharding tests need 8 virtual devices
(xla_force_host_platform_device_count, the JAX analog of a fake backend).
The GPU path is exercised by `python chip_smoke.py` on a machine with a
card, never from pytest.

jax may already be imported when conftest runs, so the platform is also
pinned through jax.config.update, which works as long as no backend has
been initialized yet.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_cache_memory():
    """Drop compiled executables between test modules.

    The suite jit-compiles hundreds of distinct CPU programs; their
    executables otherwise stay live in the pjit caches for the whole run,
    and the accumulated RSS can crash the XLA CPU compiler mid-suite
    (r5: a reproducible SIGSEGV inside backend_compile for the sharded HT
    program when run LATE in the suite; the same test passes standalone).
    Clearing per module trades a little recompilation for bounded memory.
    """
    yield
    jax.clear_caches()
