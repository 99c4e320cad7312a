"""What a measurement runs on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices, or
    RuntimeError when JAX found no GPU: a measurement never falls back to
    the CPU."""
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']})"
        )
    return info


def card_line() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
