"""Kernel ms per traced request, from the profiler trace."""

from benchmark import readers


def read(rec):
    return readers.kernel_ms_per(rec, "", "requests")
