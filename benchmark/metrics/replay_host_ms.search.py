"""Host ms of a call of a program CUDA graph (span `tfnas.graph.call`: the
arguments' flatten, checks and copies into the static buffers, and the
replay's launch), mean over the window's calls."""

from benchmark import spans


def read(rec):
    return spans.mean_ms(rec, "host_ms", "tfnas.graph.call")
