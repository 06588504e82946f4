"""Process set-up shared by the entry points (CLI, bench, chip smoke).

* :func:`enable_compile_cache` — JAX's persistent compilation cache, so a
  second process with the same programs skips XLA compilation.
* :func:`card_info` — the card's name and power limit as ``nvidia-smi``
  reports them: every measured number is printed beside it, since a card
  set below its maximum power runs slower under load.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CACHE_DIR = REPO / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory and no other
    is set.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache``:
    the directory is part of the cache key, so it must not move between
    processes (no temporary or per-process path)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info() -> str | None:
    """``name, power.limit`` of every visible NVIDIA card (one line each),
    or None when ``nvidia-smi`` is absent or fails."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None

