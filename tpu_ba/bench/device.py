"""The device a measurement runs on, and the refusal to measure without one.

Every chip number this repo records names its device: JAX's platform,
``device_kind`` and device count, plus the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load, so the limit belongs beside every time).
"""

from __future__ import annotations

import shutil
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu() -> None:
    """Exit with an error unless JAX's default backend is a GPU. A
    measurement path never falls back to the CPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU found: JAX's default backend is "
                         f"{backend!r}; refusing to measure")


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run([exe] + NVIDIA_SMI_QUERY[1:], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_record() -> dict:
    """platform / device_kind / count as JAX reports them, plus the card's
    nvidia-smi name and power limit."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": nvidia_smi_line()}


def peak_bytes_in_use(device=None) -> int:
    """High-water mark of the arrays the program allocated on ``device``."""
    import jax

    device = device or jax.devices()[0]
    return int(device.memory_stats()["peak_bytes_in_use"])
