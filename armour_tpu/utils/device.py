"""The device a measurement runs on.

Every number that claims to be the GPU's names the device it ran on, and a
measurement that finds no GPU stops instead of falling back to the CPU.
"""

import subprocess

import jax


def card_name_and_power_limit() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them (read in
    a child process that never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def require_gpu(count: int = 1) -> list:
    """Print the platform, device kind and device count JAX reports, then
    the cards' name and power limit.  Exits non-zero unless JAX sees at
    least `count` GPUs.  Returns jax.devices()."""
    devices = jax.devices()
    d = devices[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devices)}", flush=True)
    if d.platform != "gpu" or len(devices) < count:
        raise SystemExit(f"needs {count} GPU(s); JAX found {len(devices)} "
                         f"{d.platform} device(s)")
    print(f"card: {card_name_and_power_limit()}", flush=True)
    return devices
