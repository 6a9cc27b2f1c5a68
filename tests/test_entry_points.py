"""Entry-point contracts checked in subprocesses: where the persistent
compile cache lands, and that the GPU-only entry points refuse a CPU."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = ("import genomeassembler_dev, jax, jax.numpy as jnp;"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
            "print(jax.config.jax_compilation_cache_dir);"
            "jax.jit(lambda x: jnp.cos(x) * {salt})(jnp.arange(8.0))"
            ".block_until_ready()")


def _run(args, env_extra=None, drop=(), cwd=REPO, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}, **(env_extra or {}))
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_compile_cache_honours_env_var(tmp_path):
    r = _run(["-c", _COMPILE.format(salt=3)],
             {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(tmp_path)
    assert any(f.startswith("jit_") for f in os.listdir(tmp_path))


def test_compile_cache_default_is_fixed_path_in_checkout(tmp_path):
    r = _run(["-c", _COMPILE.format(salt=5)],
             drop=("JAX_COMPILATION_CACHE_DIR",), cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    cache = os.path.join(REPO, ".jax_cache")
    assert r.stdout.strip() == cache
    assert os.path.isdir(cache) and os.listdir(cache)


def test_chip_smoke_fails_on_cpu_only_jax():
    r = _run([os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
             env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_on_cpu_only_jax():
    r = _run([os.path.join(REPO, "bench.py")])
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == ""
