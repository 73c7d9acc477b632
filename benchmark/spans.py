"""The program's own spans in a run of a cell (the port's utils/trace.py:
ranges named `tfnas.*`), and the readers' arithmetic over them.

A run of the harness keeps them only where something turns the program's
tracing on and stores its snapshots in the record. This file's own entry
point does that around one --trace 1 run of the harness, without changing
what the run measures otherwise:

    python3 benchmark/run_spans.py --workload <cell> --seed <n> \
        --seconds <s>

It turns the program's tracing on before set-up; the record keeps the
snapshot of set-up as rec.program["setup"] (then resets it) when the
driver sets setup_s at the window's start, and the window's as
rec.program["window"] when the driver sets window_s after the window's
closing synchronize; the profiled section's trace is read as a SpanTrace,
which keeps the program's ranges. It prints the harness's line, then one
line {"cell", "program_metrics", "spans", "idle_share_in"}: the readers
of PROGRAM_METRICS that found something to read in the cell, each part's
spans by name and ids (count, mean host ms, mean device ms), and the
profiled section's idle share by the innermost program range open.
"""

from __future__ import annotations

import contextlib
import json
import sys
import types

from .trace import Trace

PROGRAM = "tfnas."
# the Chrome trace's categories of the program's ranges (its spans enter
# torch's _RecordFunctionFast, filed as cpu_op; record_function's ranges
# are user_annotation)
PROGRAM_CATS = ("cpu_op", "user_annotation")
# the readers of the program's spans, and the cells where each finds
# something to read
PROGRAM_METRICS = {
    "replay_host_ms.search": ("search.b32.synth",),
    "replay_host_ms.infer": ("serve.b32.folded",),
    "graph_capture_s": ("search.b32.synth", "serve.b32.folded"),
    "forward_ms.train": ("retrain.b256.synth",),
    "backward_ms.train": ("retrain.b256.synth",),
    "update_ms.train": ("retrain.b256.synth",),
    "dispatch_idle_share.train": ("retrain.b256.synth",),
}


class SpanTrace(Trace):
    """A Trace that also keeps the program's ranges inside the window."""

    def __init__(self, events):
        super().__init__(events)
        self.program = sorted(
            (e for e in events if e.get("cat") in PROGRAM_CATS
             and "dur" in e and e["name"].startswith(PROGRAM)
             and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0),
            key=lambda e: e["ts"])

    def gaps(self):
        """Every idle gap of the device inside the window, as (start,
        end) pairs in us."""
        out, reach = [], self.t0
        for a, b in self.intervals():
            if a > reach:
                out.append((reach, a))
            reach = b
        if self.t1 > reach:
            out.append((reach, self.t1))
        return out

    def program_at(self, t):
        """The name of the innermost program range open at host time t
        (the latest begun of those open), or None."""
        best = None
        for s in self.program:
            if s["ts"] > t:
                break
            if s["ts"] + s["dur"] >= t:
                best = s["name"]
        return best

    def idle_in(self, prefix):
        """Idle seconds of the window in the gaps that begin while the
        innermost open program range has a name starting with `prefix`."""
        total = 0.0
        for a, b in self.gaps():
            name = self.program_at(a)
            if name is not None and name.startswith(prefix):
                total += b - a
        return total / 1e6


# -- the readers' arithmetic -------------------------------------------------

def snapshot(rec, part):
    """The program's snapshot of `part` ("setup" or "window") that the
    run kept, or None."""
    return (getattr(rec, "program", None) or {}).get(part)


def mean_ms(rec, kind, name, part="window"):
    """Mean ms of the spans `name` in the snapshot of `part`; kind
    "host_ms" (each span's host time) or "device_ms" (the events of
    each device span)."""
    snap = snapshot(rec, part)
    ms = None if snap is None else snap[kind].get(name)
    return sum(ms) / len(ms) if ms else None


def capture_s():
    """Seconds of every CUDA-graph capture of the process (the program's
    total of its `tfnas.graph.capture` spans); None where the program
    keeps no such total or captured nothing."""
    mod = sys.modules.get("tfnas_tpu_torch.search.compiled")
    caps = getattr(mod, "captures", None)
    return caps["seconds"] if caps and caps["count"] else None


def idle_share_in(rec, prefix):
    """Percent of the traced window in which the device is idle, in the
    gaps that begin inside a program range whose name starts with
    `prefix` (SpanTrace.idle_in)."""
    t = None if rec.trace is None else rec.trace.get("obj")
    if not isinstance(t, SpanTrace) or t.window_us <= 0:
        return None
    return 100.0 * t.idle_in(prefix) * 1e6 / t.window_us


# -- a run with the program's spans kept -------------------------------------

class Record(types.SimpleNamespace):
    """A run's record that stores the program's snapshots in
    rec.program when the driver sets setup_s and window_s."""

    def __setattr__(self, key, value):
        super().__setattr__(key, value)
        if value is None or key not in ("setup_s", "window_s"):
            return
        from tfnas_tpu_torch.utils import trace
        if key == "setup_s":
            self.program["setup"] = trace.snapshot()
            trace.reset()
        else:
            self.program["window"] = trace.snapshot()


@contextlib.contextmanager
def kept(runs):
    """Inside: every harness Run made turns the program's tracing on,
    keeps its record as a Record (appended to `runs`), and the profiled
    section's trace is read as a SpanTrace. Restored after."""
    from . import harness
    from .drivers import common
    from tfnas_tpu_torch.utils import trace
    base_run, base_trace = harness.Run, common.Trace

    class SpannedRun(base_run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rec = Record(program={}, **vars(self.rec))
            runs.append(self)
            trace.reset()
            trace.enable()

    harness.Run, common.Trace = SpannedRun, SpanTrace
    try:
        yield
    finally:
        harness.Run, common.Trace = base_run, base_trace
        trace.disable()


def program_metrics(rec, cell):
    """{name: value} of the readers in PROGRAM_METRICS of `cell` that
    found something to read in the record."""
    from . import harness
    out = {}
    for name, cells in PROGRAM_METRICS.items():
        v = harness.reader(name)(rec) if cell in cells else None
        if v is not None:
            out[name] = float(v)
    return out


def summary(snap):
    """{span name (with its ids): [count, mean host ms, mean device ms or
    None]} of a snapshot."""
    host, dev = {}, {}
    for s in snap["spans"]:
        key = s["name"] + "".join(f" {k}={v}" for k, v in
                                  sorted(s["ids"].items()))
        host.setdefault(key, []).append((s["end_ns"] - s["start_ns"]) / 1e6)
    for name, ms in snap["device_ms"].items():
        dev[name] = sum(ms) / len(ms)
    return {k: [len(v), sum(v) / len(v), dev.get(k)]
            for k, v in sorted(host.items())}


def idle_by_range(rec):
    """{program range name: percent of the traced window idle in gaps
    that begin inside it} of the profiled section."""
    t = None if rec.trace is None else rec.trace.get("obj")
    if not isinstance(t, SpanTrace):
        return {}
    return {n: idle_share_in(rec, n)
            for n in sorted({s["name"] for s in t.program})}


def main(argv, t0):
    from . import harness
    harness.set_cache_env()  # before torch is imported, as harness.main
    runs = []
    with kept(runs):
        rc = harness.main(list(argv) + ["--trace", "1"], t0)
    if rc == 0 and runs:
        rec, cell = runs[0].rec, runs[0].cell["name"]
        print(json.dumps({
            "cell": cell, "program_metrics": program_metrics(rec, cell),
            "spans": {part: summary(snap)
                      for part, snap in rec.program.items()},
            "idle_share_in": idle_by_range(rec)}), flush=True)
    return rc
