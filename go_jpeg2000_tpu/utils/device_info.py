"""What ran a measurement: the JAX device and the card behind it."""
from __future__ import annotations

import subprocess


def jax_device() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """Name and power limit of each card, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit` reports them (a card set
    below its maximum power runs slower under load)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def require_gpu() -> dict:
    """The JAX device description; raises SystemExit unless it is a GPU."""
    dev = jax_device()
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is "
                         f"{dev['platform']} ({dev['kind']})")
    return dev
