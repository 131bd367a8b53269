"""The persistent compilation cache's location."""

from pathlib import Path

import jax

from tacex_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first, second = compile_cache.cache_dir(), compile_cache.cache_dir()
    assert first == second == str(REPO / ".jax_cache")
