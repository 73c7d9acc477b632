"""Device ms of the eager train step's forward (span `tfnas.train.forward`:
apply and loss), between its CUDA events, mean over the window's steps."""

from benchmark import spans


def read(rec):
    return spans.mean_ms(rec, "device_ms", "tfnas.train.forward")
