"""The 95th percentile of the latencies of all requests of the window: one
batch-32 forward of the folded net, from submission to its synchronize."""

from benchmark import readers


def read(rec):
    return readers.percentile(rec.latencies_ms, 95)
