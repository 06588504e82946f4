"""Process set-up helpers (readserver_tpu/runtime.py)."""

import jax
import pytest

from readserver_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env", [None, "given"])
def test_compile_cache_dir(monkeypatch, tmp_path, restore_cache_dir, env):
    """JAX_COMPILATION_CACHE_DIR set: that directory and no other; unset:
    the fixed <repo>/.jax_cache."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(runtime.REPO / ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_dir_is_git_ignored():
    ignored = (runtime.REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
