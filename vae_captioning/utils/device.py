"""The accelerator a measurement runs on, and a refusal to run without one.

Benchmarks and the smoke script time or check work on the GPU.  A
measurement that silently fell back to the CPU would report the CPU, so
``require_gpu`` stops the process instead.  The card's name and power
limit come from ``nvidia-smi`` in a child process that never imports
JAX, so it cannot take the card's memory: a card set below its maximum
power runs slower under load, and every number kept is reported beside
it.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, or why it could not be read."""
    try:
        r = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if r.returncode:
        return f"nvidia-smi failed (rc {r.returncode}): {r.stderr.strip()}"
    return r.stdout.strip()


def device_record() -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> Dict[str, object]:
    """The device record; exits with status 2 when JAX finds no GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        print(f"no GPU: JAX's default device is {rec['kind']!r} "
              f"({rec['platform']}); refusing to measure it",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    return rec
