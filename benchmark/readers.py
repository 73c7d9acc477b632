"""Arithmetic the metric readers (benchmark/metrics/<name>.py) share. A
reader returns None where the run recorded nothing for it to read; the
harness then leaves the metric out of the result line."""

from __future__ import annotations

import statistics


def rate(rec, count):
    """rec.counts[count] per second of the window."""
    if rec.window_s is None or count not in rec.counts:
        return None
    return rec.counts[count] / rec.window_s


def mean_event_ms(rec, name):
    """Total device ms between the CUDA events around each call of
    `name`, over their count."""
    ms = rec.cuda_ms.get(name)
    return sum(ms) / len(ms) if ms else None


def mean_host_ms(rec, name):
    ms = rec.host_ms.get(name)
    return sum(ms) / len(ms) if ms else None


def percentile(values, q):
    """The q-th percentile (0-100) of all values, linear between ranks
    (Python's statistics.quantiles, inclusive method)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def trace(rec):
    return None if rec.trace is None else rec.trace.get("obj")


def idle_share(rec):
    """Percent of the traced window in which no kernel, copy or memset
    ran on the device."""
    t = trace(rec)
    if t is None or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)


def roofline(rec, kernel):
    """Percent of the least time of the traced launches of `kernel`
    (rec.bounds[kernel]: the launches expected and the sum of their
    bounds) in the device time the trace gives them by name. None where
    the trace holds another number of launches than expected."""
    t, b = trace(rec), rec.bounds.get(kernel)
    if t is None or b is None:
        return None
    ks = t.kernels(kernel)
    if len(ks) != b["launches"] or not ks:
        return None
    return 100.0 * b["bound_s"] / (sum(e["dur"] for e in ks) / 1e6)


def mfu(rec):
    """Percent of the cards' dense bf16 peak that the model FLOPs of the
    window's work reach over the window."""
    peak = rec.peaks.get("bf16_dense_flops_per_s")
    if rec.flops is None or not rec.window_s or not peak:
        return None
    return 100.0 * rec.flops / (rec.window_s * peak * rec.chips)


def kernel_ms_per(rec, substr, count):
    """Device ms of the traced kernels whose name holds `substr`, per unit
    of rec.trace[count] (the units of work the traced section ran)."""
    t = trace(rec)
    n = None if rec.trace is None else rec.trace.get(count)
    if t is None or not n:
        return None
    ks = t.kernels(substr)
    if not ks:
        return None
    return sum(e["dur"] for e in ks) / 1e3 / n
