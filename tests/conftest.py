"""Test harness configuration.

Tests run on the CPU (unless JAX_PLATFORMS names another platform) with 8
virtual devices, so the multi-device sharding logic runs without
accelerators, and the pallas kernels run in interpret mode (configs pass
interpret=True). Tests marked `gpu` need a CUDA device and skip elsewhere;
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py` runs
them on the card, as `python chip_smoke.py` does. XLA flags must be set
before jax initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402

from gsrast_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# CPU test compiles take seconds per jit; the cache keeps reruns fast.
enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
