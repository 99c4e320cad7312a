"""Entry points: chip_smoke.py's contract, bench.py's device gate and the
compile-cache rule — the parts a CPU can check."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from parallel_gcn.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_phase_selection():
    assert chip_smoke.select_phases([]) == ["fit", "kernels"]
    assert chip_smoke.select_phases(["--multi"]) == ["multi"]
    with pytest.raises(SystemExit):
        chip_smoke.select_phases(["--bogus"])


def test_chip_smoke_result_line_shape():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": info}


def test_chip_smoke_refuses_the_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_check_raises_above_tolerance(capsys):
    chip_smoke.check("within", 1e-3, 1e-2)
    with pytest.raises(AssertionError, match="above tolerance"):
        chip_smoke.check("beyond", 1e-1, 1e-2)
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", []),
    ("chip_smoke.py", ["--multi"]),
    ("bench.py", []),
])
def test_gpu_entry_points_exit_nonzero_without_gpu(script, args):
    """Run as a process on the CPU: nonzero exit, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        # the program set no path of its own
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
