"""The compile-cache helper: follow JAX_COMPILATION_CACHE_DIR, else use the
checkout's own .jax_cache."""

import os

from babelbrain_tpu.utils.compile_cache import configure_compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_uses_the_variable_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = dict(os.environ)
    assert configure_compile_cache() == str(tmp_path)
    assert dict(os.environ) == before  # sets nothing else


def test_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = dict(os.environ)
    path = configure_compile_cache()
    assert path == os.path.join(CHECKOUT, ".jax_cache")
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == path
    after = dict(os.environ)
    after.pop("JAX_COMPILATION_CACHE_DIR")
    assert after == before
