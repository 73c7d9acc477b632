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
