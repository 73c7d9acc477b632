"""Device ms of the eager train step's backward (span `tfnas.train.backward`:
the gradients), between its CUDA events, mean over the window's steps."""

from benchmark import spans


def read(rec):
    return spans.mean_ms(rec, "device_ms", "tfnas.train.backward")
