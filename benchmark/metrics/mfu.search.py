"""Model FLOPs of the window's weight and arch steps (the sampled paths
from the picks each step drew) over the window and the dense bf16 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu(rec)
