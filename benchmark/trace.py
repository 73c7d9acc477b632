"""The benchmark's reading of a torch.profiler trace (Chrome trace JSON).

The traced section of a run lies inside a host range named WINDOW (a
`record_function` the benchmark opens before the first step and closes
after the closing synchronize). Device activity is every kernel, copy
and memset; its union inside the window is the busy time (the arithmetic
of the port's chip_smoke.py `_profile_summary` and
tools_loader_throughput `_busy`). Benchmark spans are the host ranges
whose name starts with `bench.`.
"""

from __future__ import annotations

import collections
import json

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and "dur" in e]
        win = [e for e in spans if e["name"] == WINDOW]
        if not win:
            raise ValueError(f"the trace has no '{WINDOW}' range")
        self.t0 = win[0]["ts"]
        self.t1 = win[0]["ts"] + win[0]["dur"]
        self.spans = sorted((e for e in spans
                             if e["name"].startswith("bench.")
                             and e["name"] != WINDOW),
                            key=lambda e: e["ts"])
        self.device = sorted((e for e in events
                              if e.get("cat") in DEVICE_CATS and "dur" in e
                              and e["ts"] < self.t1
                              and e["ts"] + e["dur"] > self.t0),
                             key=lambda e: e["ts"])

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_us(self):
        return self.t1 - self.t0

    def intervals(self):
        """The union of device activity inside the window, as sorted
        disjoint (start, end) pairs in us."""
        out = []
        for e in self.device:
            a = max(e["ts"], self.t0)
            b = min(e["ts"] + e["dur"], self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self):
        return sum(b - a for a, b in self.intervals())

    def kernels(self, substr):
        """Device events (kernels) whose name holds `substr`."""
        return [e for e in self.device
                if e.get("cat") == "kernel" and substr in e["name"]]

    def top_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time
        inside the window."""
        total = collections.Counter()
        for e in self.device:
            total[e["name"][:160]] += e["dur"]
        return [[k, v / 1e6] for k, v in total.most_common(n)]

    def _span_at(self, t):
        """The innermost benchmark span open at host time t."""
        best = None
        for s in self.spans:
            if s["ts"] > t:
                break
            if s["ts"] + s["dur"] >= t:
                best = s["name"]
        return best or "outside bench spans"

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds]] of the n longest idle gaps
        of the device inside the window, each named by the benchmark span
        open when the device went idle."""
        edges, reach = [], self.t0
        for a, b in self.intervals():
            if a > reach:
                edges.append((reach, a))
            reach = b
        if self.t1 > reach:
            edges.append((reach, self.t1))
        edges.sort(key=lambda g: g[0] - g[1])
        return [[self._span_at(a), (b - a) / 1e6] for a, b in edges[:n]]
