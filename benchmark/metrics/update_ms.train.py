"""Device ms of the eager train step's update (span `tfnas.train.update`:
accuracy, the group mean and SGD), between its CUDA events, mean over the
window's steps."""

from benchmark import spans


def read(rec):
    return spans.mean_ms(rec, "device_ms", "tfnas.train.update")
