"""Tests that need an NVIDIA GPU (marker ``gpu``).

The suite itself runs on the CPU backend (tests/conftest.py), so the
GPU work happens in a child process: chip_smoke.py drives the main path
on the card and compares every phase with its plain reference. Without
a card these tests skip; whether there is one is decided inside the
fixture, never at import, so every pytest worker collects the same
tests.

    python -m pytest -m gpu tests/test_gpu.py    # on a GPU machine
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu_env():
    """Environment for a child that may use the card; skips when the
    machine has none."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_env):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=gpu_env, capture_output=True, text=True,
                         timeout=1500)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
