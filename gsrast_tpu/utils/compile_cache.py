"""Persistent JAX compilation cache, shared by every entry point."""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep compiled programs across processes: in the directory
    $JAX_COMPILATION_CACHE_DIR names when it is set, otherwise in the
    repository's `.jax_cache`. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
