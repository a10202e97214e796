"""The PGO-analog compilation cache: where it goes (pure env/host, no device).

``JAX_COMPILATION_CACHE_DIR`` wins when set (the code sets no directory);
otherwise the cache lives at one fixed path inside the checkout; CPU-only
processes get no default cache (see utils/compile_cache.py)."""

import os

import jax
import pytest

from radix_sorting.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in names}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_default_dir_is_fixed_inside_checkout():
    d = compile_cache.DEFAULT_CACHE_DIR
    assert d == os.path.join(_REPO, ".jax_cache")
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_process_skips(monkeypatch):
    # explicit cpu platform (what tests/workers set): no cache, no dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert compile_cache.enable_compilation_cache() is None


def test_env_dir_honoured_and_not_overridden(monkeypatch, tmp_path):
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; the code must not set
    # another directory, on any platform (cpu included)
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_compilation_cache_dir", target)
    assert compile_cache.enable_compilation_cache() == target
    assert jax.config.jax_compilation_cache_dir == target


def test_gpu_process_uses_fixed_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    path = compile_cache.enable_compilation_cache()
    assert path == compile_cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
    # the same path on every call: the path is part of the cache key
    assert compile_cache.enable_compilation_cache() == path
