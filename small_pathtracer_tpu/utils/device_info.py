"""Which device a measurement ran on.

Every timed number this repository prints names its device: JAX's
platform, device_kind and device count, and the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load). A measurement path that finds no GPU stops; it
never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def card_name_and_power_limit() -> str:
    """First line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, read by a child process that does not import
    JAX (so it never opens the card)."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return f"nvidia-smi failed (rc={out.returncode})"
    return lines[0].strip()


def require_gpu():
    """jax.devices(), or SystemExit(2) when JAX found no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's devices are {devices[0].platform!r} "
            f"({devices[0].device_kind}); this measurement runs on the "
            "GPU only"
        )
    return devices


def describe(devices) -> str:
    """'<device_kind> x<count> [<nvidia-smi name, power limit>]'."""
    return (f"{devices[0].device_kind} x{len(devices)} "
            f"[{card_name_and_power_limit()}]")
