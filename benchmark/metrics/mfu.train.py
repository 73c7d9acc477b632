"""Model FLOPs of the window's training images (forward, and twice it for
the backward) over the window, the dense bf16 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu(rec)
