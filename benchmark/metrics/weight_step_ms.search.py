"""Device ms between CUDA events around each weight-step replay, total over
count."""

from benchmark import readers


def read(rec):
    return readers.mean_event_ms(rec, "weight_step")
