"""The device a measurement runs on, named beside every number it reports.

Speed numbers are only taken on an NVIDIA GPU: a measurement path that finds
no GPU stops instead of falling back to the host CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu(devices=None) -> None:
    """Raise SystemExit unless JAX's first device is a GPU."""
    if devices is None:
        import jax
        devices = jax.devices()
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found {platform!r}")


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (a child
    process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """JAX's view of the devices plus the first card's name and power limit,
    for the JSON line of a benchmark."""
    import jax
    devices = jax.devices()
    name, _, limit = card_info().splitlines()[0].partition(",")
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "gpu_name": name.strip(), "power_limit": limit.strip()}
