"""Device naming and the GPU gate shared by the measurement entry points.

Every number a measurement script prints names the card it ran on — JAX's
platform, ``device_kind`` and device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load). A measurement path that finds no GPU stops: a CPU
time is not a device number.
"""

from __future__ import annotations

import subprocess

__all__ = ["NoGPUError", "require_gpu", "card_name_power", "gpu_count",
           "device_record"]


class NoGPUError(RuntimeError):
    """JAX found no GPU, or ``nvidia-smi`` could not name the card."""


def require_gpu():
    """The first JAX device, or :class:`NoGPUError` if it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGPUError(
            f"needs a GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def _query_cards() -> list:
    """One ``name, power.limit`` line per card, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise NoGPUError(f"nvidia-smi could not name the card: {e}") from e
    lines = [ln.strip() for ln in out.strip().splitlines() if ln.strip()]
    if not lines:
        raise NoGPUError("nvidia-smi listed no card")
    return lines


def card_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    return _query_cards()[0]


def gpu_count() -> int:
    """Cards on this host, counted by ``nvidia-smi`` without touching JAX
    (a launcher that imported JAX would hold a card itself)."""
    return len(_query_cards())


def device_record() -> dict:
    """The device fields every measurement record carries."""
    import jax

    dev = require_gpu()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": card_name_power()}
