"""The GPU entry points fail without a GPU, and the compile-cache path
choice (JAX_COMPILATION_CACHE_DIR, else a fixed path in the checkout)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("four", [False, True], ids=["one_card", "four"])
def test_chip_smoke_fails_on_cpu(four):
    p = _run(["chip_smoke.py"] + (["--four"] if four else []), ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "a GPU is required" in p.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], tmp_path)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"],
                         ids=["default", "env"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    from treeqp_tpu.utils.platform import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
    try:
        path = enable_compile_cache(str(tmp_path / "repo"))
        if env_dir is None:
            # fixed, inside the checkout: no temp name, pid or time in it
            assert path == str(tmp_path / "repo" / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            # the variable wins and nothing is set in code
            assert path == str(tmp_path / env_dir)
            assert jax.config.jax_compilation_cache_dir == before
        assert enable_compile_cache(str(tmp_path / "repo")) == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
