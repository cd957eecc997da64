"""Device guard, device description and the persistent compile cache.

Shared by the entry points (`bench.py`, `chip_smoke.py`, `__graft_entry__.py`)
so each measures on the card or refuses, names the device with its result,
and keeps compiled programs where the next process on the same checkout
finds them.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here. Otherwise the cache is the checkout's fixed
    ``.jax_cache/`` (git-ignored): a fixed path, because the path is part of
    the cache's key.
    """
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu() -> jax.Device:
    """First device, or RuntimeError unless JAX's default backend is a GPU.

    There is no CPU fallback: a measurement that finds no card fails.
    """
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
    return jax.devices()[0]


def describe() -> dict:
    """``{"platform", "kind", "count"}`` of the default devices, as JAX says."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip()
