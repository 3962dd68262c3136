"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, else a
fixed directory in the checkout."""

import jax
import pytest

from rad_tpu.utils import compile_cache


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process's
    cache (a configured cache would persist into later tests)."""
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.append((name, value)))
    return seen


def test_env_dir_is_used(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)


def test_env_set_sets_no_other_dir(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    compile_cache.enable_compile_cache()
    assert not [u for u in updates if u[0] == "jax_compilation_cache_dir"]


def test_default_is_fixed_checkout_dir(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    want = str(compile_cache.CHECKOUT / ".rad_tpu_cache" / "jax")
    assert path == want == compile_cache.cache_dir()
    assert updates == [("jax_compilation_cache_dir", want)]
