"""What the bench tools share: the device a run measures, a synchronize for
its clock, and the card's name and power limit."""

from __future__ import annotations

import subprocess

import torch


def measured_device(device) -> torch.device:
    """`device` as a torch.device; raises SystemExit for a card that is not
    there, so a measurement never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card (tests pass device='cpu')")
    return dev


def synchronizer(dev: torch.device):
    """A function that waits for `dev`'s queued work (nothing on the CPU)."""
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[dev.index or 0] if len(lines) > (dev.index or 0) else lines[0]
