"""Device-facing plumbing that the CPU suite can check: the persistent
compile cache location, the peak-rate table, the smoke test's device
gate and the main path's optional imports."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from aruco_slam_tpu.bench import pipeline
from aruco_slam_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **extra)
    return env


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is the fixed
    .jax_cache/ at the checkout root, which git ignores."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert Path(path) == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_honours_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper changes no
    setting and the executables land in that directory."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from aruco_slam_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "before = jax.config.jax_compilation_cache_dir\n"
        "path = enable_compile_cache()\n"
        "assert jax.config.jax_compilation_cache_dir == before == path\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
        " 0)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((64, 64)))"
        ".block_until_ready()\n"
        "print(path)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, check=True,
        capture_output=True, text=True,
        env=_clean_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc")))
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "cc")
    assert any((tmp_path / "cc").iterdir()), "no cache entry written"


def test_peak_table_has_h100():
    peaks = pipeline.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops"] == 989e12
    assert peaks["tf32_flops"] == 495e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in peaks["source"]


def test_peak_table_refuses_unknown_device():
    """No default peak: an unlisted kind (the CPU here) is an error,
    and a CPU row carries the achieved rate with no device share."""
    with pytest.raises(KeyError, match="no peak rates"):
        pipeline.device_peaks()
    with pytest.raises(KeyError):
        pipeline.device_peaks("NVIDIA A100-SXM4-80GB")
    row = pipeline.flops_metrics(2e9, 1.0)
    assert row == {"gflops_per_s": 2.0}


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result on the CPU
    backend, and when the repo is not beside it."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = _clean_env()
    if alone:
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert ("needs a GPU" if not alone else "checkout") in out.stderr


def test_one_card_per_launched_process():
    """`run_offline --processes N` children each see exactly one card:
    the pid-th of the caller's CUDA_VISIBLE_DEVICES, or card pid; a
    child with no card of its own is refused."""
    from aruco_slam_tpu.parallel.dist import one_card_env

    assert one_card_env(1, {})["CUDA_VISIBLE_DEVICES"] == "1"
    env = {"CUDA_VISIBLE_DEVICES": "2,3", "OTHER": "x"}
    assert one_card_env(1, env) == {"CUDA_VISIBLE_DEVICES": "3",
                                    "OTHER": "x"}
    with pytest.raises(ValueError, match="no card"):
        one_card_env(2, {"CUDA_VISIBLE_DEVICES": "2,3"})


def test_main_path_imports_without_optional_packages():
    """The .npz main path (run_slam / run_offline / the benches) must
    import with neither imageio, matplotlib nor cv2 installed."""
    code = (
        "import sys\n"
        "for m in ('imageio', 'matplotlib', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "from aruco_slam_tpu.apps import run_slam, run_offline\n"
        "from aruco_slam_tpu.bench import large_map, pipeline\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True,
                         env=_clean_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_smoke_phase_failure_fails_the_run(capsys):
    """A phase that raises is reported and recorded (the run then
    exits 1 without a result line); a passing phase returns its value
    and records nothing."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    sm = chip_smoke.Smoke("test card, 1 W")

    def bad(_sm):
        chip_smoke.check(False, "deliberate mismatch")

    assert sm.phase("good", lambda _sm: 7) == 7
    assert sm.phase("bad", bad) is None
    assert sm.failed == ["bad"]
    out = capsys.readouterr()
    assert "== bad: FAILED" in out.out
    assert "deliberate mismatch" in out.err
