"""Device ms between CUDA events around each train_step, total over count."""

from benchmark import readers


def read(rec):
    return readers.mean_event_ms(rec, "train_step")
