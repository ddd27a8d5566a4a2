"""config: the compile-cache helper and the accelerator check."""
from pathlib import Path

import jax

from smart_crossover_tpu import config


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.use_compile_cache() == str(tmp_path)
    # JAX's own setting is left alone
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_the_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = config.use_compile_cache()
        want = Path(__file__).resolve().parent.parent / ".jax_cache"
        assert got == str(want)
        assert jax.config.jax_compilation_cache_dir == str(want)
        # the same path every call: the path is part of the cache key
        assert config.use_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cpu_backend_is_not_an_accelerator():
    assert config.default_backend() == "cpu"
    assert not config.on_accelerator()
