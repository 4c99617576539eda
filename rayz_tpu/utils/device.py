"""The device a measurement ran on.

Every speed figure is named with the device it came from: JAX's platform,
device kind and count, and the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
Measurement entry points call :func:`require_gpu` first, so a machine
without a GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["require_gpu", "device_info", "card"]


def require_gpu() -> None:
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card() -> str:
    """``name, power limit`` of the first card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
