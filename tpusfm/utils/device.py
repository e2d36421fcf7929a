"""What a measurement ran on: the JAX device and, on NVIDIA cards, the
card's name and power limit as nvidia-smi reports them."""

from __future__ import annotations

import subprocess

import jax


def describe() -> dict:
    """{"platform", "kind", "count"} of the default backend's devices, as
    JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card (a card
    set below its maximum power runs slower under load), or None without
    nvidia-smi.  Runs in a child process that does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None

