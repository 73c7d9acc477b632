"""Training images completed per second of the window, summed over the
cards; the window ends in a synchronize."""

from benchmark import readers


def read(rec):
    return readers.rate(rec, "images")
