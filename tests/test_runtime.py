"""Compile-cache location and the device gate shared by the CLI, the
benchmarks and the chip smoke test."""

import pathlib

import pytest

from genome_cycle_tpu.utils import runtime

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_one_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.compile_cache_dir()
    assert first == runtime.compile_cache_dir()
    assert pathlib.Path(first) == CHECKOUT / ".jax_cache"


def test_enable_compile_cache_configures_nothing_when_set(monkeypatch,
                                                          tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_points_jax_at_the_checkout(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = runtime.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
        assert path == str(CHECKOUT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
