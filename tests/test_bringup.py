"""Start-up plumbing: where the persistent compile cache lives, the smoke
script's refusal to run without a GPU, and precompile failures surfacing
from SLAMSystem.wait_compiles()."""
import os
import subprocess
import sys
import tempfile

import pytest

import hslam_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_env_var_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/srv/cache/jax"}
    assert hslam_tpu.compile_cache_dir(env) == "/srv/cache/jax"


def test_compile_cache_dir_default_is_fixed_in_checkout():
    d = hslam_tpu.compile_cache_dir({})
    assert d == hslam_tpu.compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    assert not d.startswith(tempfile.gettempdir() + os.sep)
    assert str(os.getpid()) not in d


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU found" in out.stdout


def test_wait_compiles_raises_precompile_failure(monkeypatch):
    from hslam_tpu.config import Config
    from hslam_tpu.models.system import SLAMSystem

    def fail(self):
        raise RuntimeError("kernel failed to compile")

    monkeypatch.setattr(SLAMSystem, "_precompile_selector", fail)
    for stage in ("_precompile_main_path", "_precompile_reloc",
                  "_precompile_lc", "_precompile_photocal"):
        monkeypatch.setattr(SLAMSystem, stage, lambda self: None)
    slam = SLAMSystem(40.0, 40.0, 31.5, 23.5, 64, 48,
                      Config(max_frames=4, max_points=64, max_immature=64,
                             pyr_levels=3),
                      enable_loop_closure=False, sequential=False)
    try:
        with pytest.raises(RuntimeError, match="failed to compile"):
            slam.wait_compiles()
        slam.wait_compiles()   # reported once
    finally:
        slam.close()
