"""Compile-cache placement: the deployment's JAX_COMPILATION_CACHE_DIR,
else the checkout's fixed ``.jax_cache``."""

import os

import jax
import pytest

import gnss_sdr_tpu
from gnss_sdr_tpu.utils.compile_cache import (default_cache_dir,
                                              enable_compile_cache)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # no path set in code


def test_unset_env_uses_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(gnss_sdr_tpu.__file__))
    assert path == os.path.join(checkout, ".jax_cache") == default_cache_dir()
    assert jax.config.jax_compilation_cache_dir == path
    assert enable_compile_cache() == path  # stable across calls
