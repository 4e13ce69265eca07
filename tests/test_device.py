"""Compile-cache and device helpers (catears_tpu.utils.device)."""

import os

import jax
import pytest

from catears_tpu.utils import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after the test."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


class TestCompileCache:
    def test_env_set_is_the_only_dir(self, monkeypatch, cache_config):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(device.CACHE_ENV, "/some/where")
        assert device.enable_compile_cache() == "/some/where"
        assert jax.config.jax_compilation_cache_dir == before

    def test_env_unset_uses_fixed_checkout_dir(self, monkeypatch,
                                               cache_config):
        monkeypatch.delenv(device.CACHE_ENV, raising=False)
        path = device.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # Same path on every call: no temp name, pid or time in it.
        assert device.enable_compile_cache() == path

    def test_default_dir_is_gitignored(self):
        with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as fd:
            assert ".jax_cache/" in fd.read().split()


class TestRequireGpu:
    def test_raises_on_cpu(self):
        assert jax.devices()[0].platform == "cpu"
        with pytest.raises(RuntimeError, match="no GPU"):
            device.require_gpu()

    def test_device_record_raises_on_cpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            device.device_record()
