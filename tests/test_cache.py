"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
else one fixed directory inside the checkout."""

import os

import jax
import pytest

from go_tfhe_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured(monkeypatch, tmp_path, restore_cache_dir):
    """With the variable set, JAX already reads it: nothing is set in code."""
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_default_ignores_cwd_home_and_tmp(monkeypatch, tmp_path,
                                          restore_cache_dir):
    """No temp name, pid, time, home or working directory enters the path:
    every process of a checkout finds the same cache."""
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    assert cache.enable_compilation_cache() == os.path.join(REPO,
                                                            ".jax_cache")
