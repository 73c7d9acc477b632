"""The port's spans: named host ranges around its own work, on the clock
of torch.profiler's trace, and device times of eager code.

One switch, off by default: `enable()` / `disable()`, or TFNAS_TRACE=1 in
the environment when this module is first imported. Off, `span()` returns
one shared null context: a global read, no allocation and no torch call.
The block spans (`block_span()`, `backward_span()`) open only after
`enable(blocks=True)`: they are finer than the train step's phases, which
their readers take to be the innermost spans open. On, a span

- enters a profiler range of its name (torch's `_RecordFunctionFast`:
  `torch.profiler.record_function` at about a twentieth of its host cost,
  whose events the Chrome trace files as `cpu_op`), so that inside a
  profiler session the range lies in the trace beside the kernels, on
  their clock;
- keeps a record in memory: its name, start and end (`perf_counter_ns`),
  its parent (the span open on the same thread when it began) and its ids
  (such as a graph's name);
- with `device=True`, also records a timing CUDA event on the current
  stream at entry and at exit (eager code only: under a stream capture it
  records none, and none where CUDA is not initialised).

`backward_span(t, name)` opens a device span of `name` in the backward
pass when t's gradient arrives; it closes when the pass's next such span
opens, or when the pass ends. On the outputs of a chain of blocks these
spans tile the pass: each block's backward lies in the span of its output.

`clock()` is a span that measures its host time whether tracing is on or
off (for numbers the program reports anyway, such as a graph's build
time); it is recorded only when tracing is on. `snapshot()` returns the
closed spans as plain data, `reset()` forgets them. Nothing writes files.
The drivers (train_search, train_search_pareto, train_eval) reset at each
epoch, so that a traced run keeps one epoch of spans in memory.

`launch_counters` holds every hand-written kernel's launch counter
(kernels/nvcc.LaunchCounter) by kernel name: the graph module
(search/compiled.py) reads them at each capture and adds to them at each
replay without knowing the kernels.

Span names:
  tfnas.graph.call, .args, .replay, .capture   search/compiled.AutoGraphed
  tfnas.train.forward, .backward, .update       parallel/train_dp train_step
  tfnas.search.fetch, .step                     train_search's per-step log
  tfnas.block.mbconv, .attn (device, blocks)    models/eval_net apply, each
                                                block (stems and convolutional
                                                blocks in .mbconv), forward
                                                and backward
  tfnas.attn.core (device, blocks)              ops/attention rel_attention:
                                                q.k, bias, softmax, .v
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

NULL = contextlib.nullcontext()
_on = os.environ.get("TFNAS_TRACE", "") == "1"
_blocks = False
_local = threading.local()
_closed = []   # spans closed since the last reset, from every thread
# kernel name -> kernels/nvcc.LaunchCounter, in the order they were made
launch_counters = {}


def enable(blocks=False):
    global _on, _blocks
    _on, _blocks = True, blocks


def disable():
    global _on, _blocks
    _on = _blocks = False


def enabled():
    return _on


class Span:
    """One timed range. `ms` is its host time once closed."""

    __slots__ = ("name", "ids", "parent", "thread", "start_ns", "end_ns",
                 "events", "_kept", "_device", "_range", "_held")

    def __init__(self, name, ids, device=False, kept=True):
        self.name, self.ids = name, ids
        self._kept, self._device = kept, device
        self.parent = self.thread = self.events = self._range = None
        self._held = None  # the stack it was entered on
        self.start_ns = self.end_ns = None

    def __enter__(self):
        if self._kept:
            stack = self._held = _stack()
            self.parent = stack[-1] if stack else None
            self.thread = threading.get_ident()
            stack.append(self)
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
            if self._device and torch.cuda.is_initialized() and \
                    not torch.cuda.is_current_stream_capturing():
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._kept:
            if self.events is not None:
                self.events[1].record()
            self._range.__exit__(*exc)
            self._range = None
            # a generator's span may close out of order, a backward span
            # on another thread
            if self in self._held:
                self._held.remove(self)
            _closed.append(self)
        return False

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        """Device ms between the span's events (waits for the end event);
        None without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name, device=False, **ids):
    """A recorded span when tracing is on; the shared null context off."""
    if not _on:
        return NULL
    return Span(name, ids, device)


_backward = []  # the open backward span of the pass in progress


def block_span(name):
    """A recorded device span when the block spans are on; the shared null
    context otherwise."""
    if not _blocks:
        return NULL
    return Span(name, {}, True)


def backward_span(t, name):
    """t, with a hook that opens the device span `name` when t's gradient
    arrives in a backward pass, closing the one the pass opened before;
    the pass's last closes when the pass ends. t as it is when the block
    spans are off, t needs no gradient or its stream is capturing."""
    if not _blocks or not t.requires_grad or (
            t.is_cuda and torch.cuda.is_current_stream_capturing()):
        return t
    t.register_hook(lambda g: _open_backward(name))
    return t


def _open_backward(name):
    if _backward:
        _close_backward()
    else:
        torch.autograd.Variable._execution_engine.queue_callback(
            _close_backward)
    s = Span(name, {}, device=True)
    s.__enter__()
    _backward.append(s)


def _close_backward():
    if _backward:
        _backward.pop().__exit__(None, None, None)


def clock(name, **ids):
    """A span that always measures its host time (`ms` once closed) and is
    recorded only when tracing is on."""
    return Span(name, ids, kept=_on)


def snapshot():
    """The spans closed since the last reset, as plain data:
    {"host_ms": {name: [ms, ...]}, "device_ms": {name: [ms, ...]} (device
    spans only; waits for their end events), "spans": [{"name",
    "start_ns", "end_ns", "parent" (its name or None), "ids", "thread"}]}
    in the order they closed."""
    spans = list(_closed)
    host, device = {}, {}
    for s in spans:
        host.setdefault(s.name, []).append(s.ms)
        d = s.device_ms()
        if d is not None:
            device.setdefault(s.name, []).append(d)
    return {"host_ms": host, "device_ms": device, "spans": [
        {"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
         "parent": None if s.parent is None else s.parent.name,
         "ids": dict(s.ids), "thread": s.thread} for s in spans]}


def reset():
    """Forget the closed spans (open ones are recorded when they close)."""
    _closed.clear()
