"""The trace reduction and the readers' arithmetic on a small recorded
trace: busy union, idle share, idle gaps by host span, kernel time by
name, roofline and MFU shares."""

import types

import pytest

from benchmark import readers
from benchmark.trace import WINDOW, Trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    ev("user_annotation", WINDOW, 100, 1000),
    ev("user_annotation", "bench.step", 100, 400),
    ev("user_annotation", "bench.load", 600, 300),
    ev("kernel", "fused_dw_kernel<bf16,1>", 50, 100),   # 100..150 inside
    ev("kernel", "gemm", 140, 160),                      # overlaps: ..300
    ev("gpu_memcpy", "Memcpy HtoD", 400, 100),           # 400..500
    ev("kernel", "fused_dw_kernel<bf16,2>", 700, 100),   # 700..800
    ev("kernel", "late", 1050, 200),                     # ..1100 inside
    ev("cpu_op", "aten::mul", 120, 5),
]


def test_busy_idle_and_gaps():
    t = Trace(EVENTS)
    assert t.window_us == 1000
    assert t.intervals() == [[100, 300], [400, 500], [700, 800],
                             [1050, 1100]]
    assert t.busy_us() == 450
    gaps = [[n, round(s * 1e6)] for n, s in t.idle_gaps(10)]
    assert gaps == [["bench.load", 250], ["bench.step", 200],
                    ["bench.step", 100]]
    assert dict((n, round(s * 1e6)) for n, s in t.top_ops(3))[
        "fused_dw_kernel<bf16,1>"] == 100


def rec_of(trace=None, **kw):
    base = dict(setup_s=1.0, window_s=2.0, counts={}, latencies_ms=[],
                cuda_ms={}, host_ms={}, flops=None, trace=None, bounds={},
                chips=1, peaks={"bf16_dense_flops_per_s": 1e12})
    if trace is not None:
        base["trace"] = {"obj": trace, "steps": 2, "requests": 4}
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers_arithmetic():
    t = Trace(EVENTS)
    rec = rec_of(t, bounds={"fused_dw": {"launches": 2, "bound_s": 50e-6}},
                 flops=4e11, counts={"images": 300})
    assert readers.idle_share(rec) == pytest.approx(55.0)
    # bound 50 us over the kernel's 200 us in the trace
    assert readers.roofline(rec, "fused_dw") == pytest.approx(25.0)
    assert readers.mfu(rec) == pytest.approx(20.0)
    assert readers.rate(rec, "images") == pytest.approx(150.0)
    assert readers.kernel_ms_per(rec, "gemm", "steps") == pytest.approx(
        0.08)


def test_readers_find_nothing():
    t = Trace(EVENTS)
    # another number of launches than expected: no roofline
    rec = rec_of(t, bounds={"fused_dw": {"launches": 3, "bound_s": 1.0}})
    assert readers.roofline(rec, "fused_dw") is None
    rec = rec_of()
    assert readers.idle_share(rec) is None
    assert readers.mfu(rec) is None
    assert readers.mean_event_ms(rec, "weight_step") is None
    assert readers.percentile([1.0], 95) is None


def test_p95_is_the_tail_of_all_values():
    vals = [float(i) for i in range(1, 101)]
    assert readers.percentile(vals, 95) == pytest.approx(95.05)
