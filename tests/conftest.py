"""Test harness config: a virtual 8-device CPU mesh, and the ``gpu`` marker.

The tier-1 suite runs with ``JAX_PLATFORMS=cpu``; tests marked ``gpu``
need a card and skip elsewhere (the ``gpu`` fixture decides, at run time).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import numpy as np
import pytest

from tpu_debruijn import compile_cache

# the suite is dominated by CPU XLA compiles of shape-specialized
# programs; cache them across runs (unless a caller, e.g. chip_smoke.py
# running the gpu tests in process, already chose a cache)
if not jax.config.jax_compilation_cache_dir:
    compile_cache.configure(".jax_cache_cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none"
    )


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skip otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free live compiled executables after every module.

    With the whole suite in one process, ~300 live XLA:CPU executables
    accumulate; at that age, compiling OR (de)serializing the largest
    programs (the 8-device shard_map pipelines) intermittently segfaults
    inside jaxlib 0.9.0 (repro: 6 full-suite runs crashed in
    backend_compile_and_load / executable.serialize / deserialize, always
    past ~270 tests; any ~180-test subset is stable, and every module
    passes standalone).  Dropping executables between modules keeps the
    live set small; the persistent compilation cache makes the re-JITs
    cheap deserializes."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
