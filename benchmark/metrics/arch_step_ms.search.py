"""Device ms between CUDA events around each arch-step replay, total over
count."""

from benchmark import readers


def read(rec):
    return readers.mean_event_ms(rec, "arch_step")
