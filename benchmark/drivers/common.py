"""Pieces the drivers share: device synchronisation, tree copies, CUDA
event timers around calls, the profiled section and its reduction."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from ..trace import WINDOW, Trace


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone() if torch.is_tensor(tree) else tree


class EventTimer:
    """CUDA events around calls, by name: total device ms over count once
    the events have completed. On the CPU, nothing is recorded."""

    def __init__(self, device):
        self.on = device.type == "cuda"
        self.pairs = {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*a, **k)
            end.record()
            self.pairs.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self):
        return {n: [s.elapsed_time(e) for s, e in p]
                for n, p in self.pairs.items()}


class Throttle:
    """Keeps at most `depth` steps queued ahead of the device: before
    handing out the next batch, wait for the event recorded `depth` batches
    earlier. Bounds how far a run's window outlasts --seconds without
    leaving the device idle."""

    def __init__(self, device, depth=2):
        self.on = device.type == "cuda"
        self.depth, self.events = depth, []

    def step(self):
        if not self.on:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()


def timed_batches(batches, seconds, throttle, counter):
    """Yield from the endless iterator `batches` until `seconds` have
    passed since the first batch; counter["n"] counts the batches."""
    t_end = None
    for b in batches:
        now = time.perf_counter()
        if t_end is None:
            t_end = now + seconds
        elif now >= t_end:
            return
        throttle.step()
        counter["n"] += 1
        yield b


@contextlib.contextmanager
def profiled(device, out):
    """torch.profiler (CPU and CUDA activity) over the body, which runs
    inside the WINDOW range and ends in a synchronize. The reduction of
    the trace is stored in out["trace"] (a Trace) and the file deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["trace"] = Trace.load(path)
    finally:
        os.unlink(path)


def trace_summary(trace):
    """The device entries of a traced run's result line."""
    return {"busy_s": trace.busy_us() / 1e6,
            "window_s": trace.window_us / 1e6,
            "breakdown": {"device_ops": trace.top_ops(10),
                          "idle_gaps": trace.idle_gaps(10)}}


def free_cuda(device):
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
