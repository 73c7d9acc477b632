"""Percent of the traced window in which the device ran nothing."""

from benchmark import readers


def read(rec):
    return readers.idle_share(rec)
