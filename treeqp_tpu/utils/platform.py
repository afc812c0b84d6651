"""Device and compile-cache helpers for the entry points (CLI, benchmark,
smoke check).

Measurement paths require the GPU and fail without it: a number from
another backend is never reported under a device's name.
"""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["enable_compile_cache", "require_gpu", "card_info"]


def enable_compile_cache(root: str) -> str:
    """Persistent compile cache: where ``JAX_COMPILATION_CACHE_DIR`` says
    (JAX reads the variable itself), else the fixed ``<root>/.jax_cache``.
    The path is part of the cache key, so it never depends on a temporary
    name, a process id or the time. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be a GPU (no CPU fallback)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"a GPU is required; JAX found {dev.platform!r}")
    return dev


def card_info() -> str:
    """``name, power.limit`` of the cards, from nvidia-smi in a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
