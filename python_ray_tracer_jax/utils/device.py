"""What a measurement runs on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """The first JAX device; raises unless it is a GPU (no CPU fallback)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"needs a GPU, JAX found {dev.platform!r} ({dev.device_kind})")
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line(s) for the visible cards.

    Read in a child process, which does not touch JAX or the card's memory.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
