"""The fused depthwise kernel's share of its roofline: the least time of
every traced launch (bytes at the memory rate against its operations at
the f32 rate) over the kernel's device time in the trace, by name."""

from benchmark import readers


def read(rec):
    return readers.roofline(rec, "fused_dw")
