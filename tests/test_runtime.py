"""Process set-up: compile-cache placement and the GPU device guard."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PROBE = ("import jax; from nanopore_dna_storage.runtime import "
         "enable_compile_cache; d = enable_compile_cache(); "
         "print(d); print(jax.config.jax_compilation_cache_dir)")


def _cache_dirs(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set over it; without
    it the cache sits at <repo>/.jax_cache."""
    want = str(tmp_path / "cache") if from_env else str(REPO / ".jax_cache")
    assert _cache_dirs(want if from_env else None) == [want, want]


def test_chip_smoke_guard_raises_on_cpu(capsys):
    """chip_smoke.py refuses to run without a GPU and prints no result."""
    import chip_smoke

    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu()
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
