"""What the measurement scripts (``bench_*.py``, ``mb_scan_int8.py``) share:
the line that names the device a script ran on, a device sync and the
H100's HBM rate.

Every script runs on the card unless ``--device cpu`` asks for the CPU; on
the card the kernel wrappers launch the hand-written kernels, on CPU tensors
they take their plain versions. Nothing falls back: a script asked for the
card on a machine without one raises.
"""

from __future__ import annotations

import subprocess

import torch

# H100 SXM HBM3 (data sheet): the roofline the scripts' bytes are held to
HBM_BYTES_S = 3.35e12


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (``"cpu"`` on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device() if len(out) > 1 else 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
