"""Forward FLOPs of the window's requests over the window and the dense
bf16 peak."""

from benchmark import readers


def read(rec):
    return readers.mfu(rec)
