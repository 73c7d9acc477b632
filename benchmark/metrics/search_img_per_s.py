"""Training images through weight steps per second of the window: the
batch times the weight steps completed (arch steps between them counted in
the time), over a window that ends in a synchronize."""

from benchmark import readers


def read(rec):
    return readers.rate(rec, "images")
