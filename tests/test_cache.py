"""Persistent compile-cache helper (mappy_rs_tpu/utils/cache.py)."""
import os

import jax
import pytest

from mappy_rs_tpu.utils import cache


@pytest.fixture
def restore_jax_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_dir_is_used_and_no_other(tmp_path, monkeypatch,
                                      restore_jax_cache_config):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv(cache.ENV, env_dir)
    root = tmp_path / "checkout"
    root.mkdir()
    got = cache.enable_compile_cache(str(root))
    assert got == env_dir
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert not (root / ".jax_cache").exists()


def test_fixed_in_checkout_dir_without_env(tmp_path, monkeypatch,
                                           restore_jax_cache_config):
    monkeypatch.delenv(cache.ENV, raising=False)
    got = cache.enable_compile_cache(str(tmp_path))
    assert got == os.path.join(str(tmp_path), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # the same root always maps to the same directory (it is part of
    # the cache key): nothing derived from time, pid or temp names
    assert cache.cache_dir(str(tmp_path)) == got
