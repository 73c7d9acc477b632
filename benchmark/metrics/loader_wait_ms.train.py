"""Host ms per step spent waiting in next() on the driver's prefetcher for
the next device batch, mean over the window."""

from benchmark import readers


def read(rec):
    return readers.mean_host_ms(rec, "loader_wait")
