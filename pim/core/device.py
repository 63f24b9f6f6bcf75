"""What the program runs on: JAX's device and the card behind it.

Every timed result names its device.  A measurement path that finds no GPU
stops (`require_gpu`); it never falls back to timing the CPU.
"""

from __future__ import annotations

import subprocess


def describe() -> dict:
    """JAX's view of the devices: platform, device_kind, count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev['platform']!r} "
            f"({dev['kind']}); this measures the GPU only")
    return dev


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them
    (run in a child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
