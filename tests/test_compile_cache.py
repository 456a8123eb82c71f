"""The persistent compilation-cache helper and chip_smoke.py's refusal to
run without a GPU."""

import os

import jax
import pytest

from parelagmc_tpu.utils import compile_cache


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_device_phase_fails_on_cpu():
    import chip_smoke

    with pytest.raises(SystemExit, match="phase device failed"):
        chip_smoke.device_phase()
