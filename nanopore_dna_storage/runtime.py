"""Process set-up shared by the entry points: the device guard and the
placement of JAX's persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at import and this
module sets nothing. Otherwise the cache lives at ``<repo>/.jax_cache`` (a
fixed path, listed in .gitignore), so every entry point of one checkout
shares one cache.
"""
from __future__ import annotations

import os
import pathlib

import jax

REPO_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)


def require_gpu():
    """The device guard of measurement entry points: JAX's default device
    must be a GPU (no fallback to the CPU). Returns ``jax.devices()``."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"a GPU is required; JAX's default device is "
            f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def device_info() -> dict:
    """The default device as JAX reports it, for result lines."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
