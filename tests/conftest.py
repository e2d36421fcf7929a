"""Test configuration.

By default every test runs on a virtual 8-device CPU mesh (SURVEY.md §4:
the CPU mesh stands in for a multi-device machine), with Pallas kernels in
interpret mode.  Tests marked `gpu` need an NVIDIA GPU; run them on the
card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

(any JAX_PLATFORMS other than "cpu" keeps this file from forcing the CPU
platform).  Whether a GPU is present is decided in the `gpu` fixture, never
at import or collection time, so every xdist worker collects the same
tests.
"""

import os

import jax

if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

from tpusfm.utils import compile_cache  # noqa: E402

compile_cache.enable()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda on the card)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live executables between test modules.

    A full-suite run accumulates ~150 tests' compiled XLA:CPU executables in
    one process; with that much live runtime state the largest program in
    the suite (the fused two-view reconstruction) segfaults inside XLA:CPU
    execution — reproducibly at the same test, while any subset of the
    suite passes.  Clearing per module keeps peak state bounded; recompiles
    are absorbed by the persistent compilation cache (disk reload, ~0.1 s)."""
    yield
    jax.clear_caches()
