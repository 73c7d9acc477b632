"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """The device an entry point runs on: the card unless the caller asks
    for another. Raises when CUDA is asked for and no card is present —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def describe(device):
    """What a measurement ran on: for the card, `nvidia-smi`'s name and
    power limit (a card set below its maximum runs slower under load) and
    torch's device name; for the CPU, 'cpu'."""
    if device.type != "cuda":
        return {"device": "cpu"}
    import subprocess
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi or None}
