"""Test config: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise: it needs
float64 oracles and an 8-device virtual mesh, and runs the Pallas kernels
in interpret mode.  Tests marked ``gpu`` need the card; on a GPU machine
they run with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` and
they skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # older jax: the XLA_FLAGS path above covers it

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided here, never at import)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:  # no GPU backend in this process
        devs = []
    if not devs:
        pytest.skip("needs a GPU")
    return devs[0]


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound per-process XLA:CPU compiler state.

    A single full-suite process accumulates hundreds of compiled
    executables; past ~200 compile-heavy tests the XLA:CPU backend
    segfaulted INSIDE a later compile (faulthandler stack in
    backend_compile_and_load) while the same tests pass in split runs.
    Dropping the executable caches at module boundaries keeps the
    accumulated JIT state bounded; cross-module compile reuse is minimal,
    so the wall-clock cost is small."""
    yield
    jax.clear_caches()
