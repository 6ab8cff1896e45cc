"""The compile-cache helper (utils/cache.py) and the GPU-only entry points."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from python_ray_tracer_jax.utils import cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_is_used_as_is(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_default_is_one_fixed_ignored_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cache.enable_compile_cache()
    assert first == str(REPO / ".jax_cache") == cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == first
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_cpu():
    from python_ray_tracer_jax.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()
