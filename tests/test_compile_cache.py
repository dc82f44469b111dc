"""Where the persistent compilation cache goes."""

import jax
import pytest

from cvgpuspeedup_tpu.utils import compile_cache


@pytest.fixture
def restore_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_goes_to_repo_dir_without_env(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(compile_cache.REPO_CACHE_DIR)
    assert compile_cache.REPO_CACHE_DIR.name == ".jax_cache"
    assert (compile_cache.REPO_CACHE_DIR.parent / "chip_smoke.py").exists()
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_env_dir_is_left_to_jax(monkeypatch, restore_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_importing_the_library_sets_no_cache():
    import subprocess
    import sys

    code = ("import os; os.environ.pop('JAX_COMPILATION_CACHE_DIR', None); "
            "import jax, cvgpuspeedup_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"JAX_PLATFORMS": "cpu", "PATH": ""},
                         cwd=str(compile_cache.REPO_CACHE_DIR.parent))
    assert out.stdout.strip() == "None"
