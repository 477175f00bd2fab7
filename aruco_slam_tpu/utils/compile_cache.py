"""Persistent XLA compilation cache shared by every entry point.

The image pipeline and the survey-scale filter take tens of seconds to
compile; caching the executables on disk lets a second run of a bench,
an app or the chip smoke test skip that.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it, so this
  module sets nothing and reports that directory.
* unset: the cache lives in ``.jax_cache/`` at the root of the
  checkout (listed in ``.gitignore``). A fixed path matters: the
  directory is part of what the cache is keyed on, so a per-run
  temporary directory would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use. Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
