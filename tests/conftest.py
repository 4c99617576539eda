"""Test environment: CPU backend with 8 virtual devices, and x64 enabled so
float64 parity oracles are exact.

Tests that need the card are marked ``gpu`` and take the ``gpu`` fixture,
which skips them on any other backend. ``chip_smoke.py`` runs them on the
GPU in its own process with ``JAX_PLATFORMS=cuda``; under any other value
(or none) the suite is pinned to the CPU here, before a backend starts."""

import os

ON_GPU = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import, so that
    every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs it on the card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the XLA CPU compiler's cumulative memory: dropping compiled
    executables between modules (several compile interpret-mode kernel
    programs) keeps one long-lived worker process small. Costs nothing
    across modules (they share almost no jit signatures)."""
    yield
    jax.clear_caches()
