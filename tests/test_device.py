"""The kernel route for each platform and the compile-cache directory."""

import jax
import pytest

from diffwdf import device


@pytest.mark.parametrize(
    "platform,route", [("cpu", "interpret"), ("gpu", "triton")]
)
def test_kernel_route(platform, route):
    assert device.kernel_route(platform) == route
    assert device.use_interpret(platform) == (route == "interpret")


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_kernel_route_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        device.kernel_route(platform)


def test_kernel_route_defaults_to_the_backend():
    assert jax.default_backend() == "cpu"
    assert device.kernel_route() == "interpret"


def test_compile_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_inside_the_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(device.__file__)))
    assert path == os.path.join(checkout, ".jax_cache") == device.DEFAULT_CACHE_DIR
    assert device.compile_cache_dir() == path  # no pid, time or temp name
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_the_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
