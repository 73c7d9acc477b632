"""The readers of the program's own spans (benchmark/spans.py) on a small
recorded trace and record: idle time by the innermost program range, the
window's host and device means, the capture total; nothing where a run
kept nothing (as at a parent commit). And a CPU run of a tiny cell with
the spans kept: the set-up's and the window's snapshots, the profiled
section read as a SpanTrace, the harness's own readings as they were."""

import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import tiny
from benchmark.trace import WINDOW, Trace


def ev(name, ts, dur, cat="user_annotation"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    ev(WINDOW, 100, 1000),
    ev("bench.train_step", 100, 700),
    ev("tfnas.train.forward", 110, 200, "cpu_op"),
    ev("tfnas.train.backward", 320, 300, "cpu_op"),
    ev("tfnas.graph.call", 630, 100, "cpu_op"),
    ev("tfnas.graph.replay", 680, 40, "user_annotation"),
    ev("tfnas.other", 900, 100, "cpu_op"),
    ev("aten::mm", 250, 10, "cpu_op"),     # no program range
    ev("gemm", 100, 150, "kernel"),        # idle 250..400: forward's
    ev("gemm", 400, 100, "kernel"),        # idle 500..600: backward's
    ev("gemm", 600, 100, "kernel"),        # idle 700..950: replay's
    ev("gemm", 950, 100, "kernel"),        # idle 1050..1100: outside
]


def test_idle_in_the_innermost_program_range():
    t = spans.SpanTrace(EVENTS)
    assert t.gaps() == [(250, 400), (500, 600), (700, 950), (1050, 1100)]
    assert t.program_at(260) == "tfnas.train.forward"
    assert t.program_at(700) == "tfnas.graph.replay"   # inside the call
    assert t.program_at(1060) is None
    assert t.idle_in("tfnas.train.") == pytest.approx(250e-6)
    assert t.idle_in("tfnas.graph.") == pytest.approx(250e-6)
    assert t.idle_in("tfnas.graph.call") == 0.0
    # what the base Trace reads is unchanged
    base = Trace(EVENTS)
    assert t.busy_us() == base.busy_us() and \
        t.idle_gaps(10) == base.idle_gaps(10)


def rec_of(program=None, trace=None):
    rec = types.SimpleNamespace(trace=None if trace is None else
                                {"obj": trace})
    if program is not None:
        rec.program = program
    return rec


def snap(host=None, device=None):
    return {"host_ms": host or {}, "device_ms": device or {}, "spans": []}


def test_readers_of_the_window():
    rec = rec_of({"setup": snap({"tfnas.graph.call": [900.0]}),
                  "window": snap(
                      {"tfnas.graph.call": [0.2, 0.4, 0.3]},
                      {"tfnas.train.forward": [40.0, 44.0],
                       "tfnas.train.backward": [90.0, 92.0],
                       "tfnas.train.update": [15.0, 17.0]})},
                 spans.SpanTrace(EVENTS))
    got = {m: harness.reader(m)(rec) for m in spans.PROGRAM_METRICS
           if m != "graph_capture_s"}
    assert got == pytest.approx({
        "replay_host_ms.search": 0.3, "replay_host_ms.infer": 0.3,
        "forward_ms.train": 42.0, "backward_ms.train": 91.0,
        "update_ms.train": 16.0,
        # 250 us of the 1000 us window
        "dispatch_idle_share.train": 25.0})


def test_readers_find_nothing_where_the_run_kept_nothing(monkeypatch):
    from tfnas_tpu_torch.search import compiled
    plain = rec_of(trace=Trace(EVENTS))   # a parent's traced record
    for m in spans.PROGRAM_METRICS:
        if m != "graph_capture_s":
            assert harness.reader(m)(plain) is None, m
    monkeypatch.setattr(compiled, "captures", {"count": 0, "seconds": 0.0})
    assert harness.reader("graph_capture_s")(plain) is None
    monkeypatch.setattr(compiled, "captures", {"count": 2, "seconds": 3.5})
    assert harness.reader("graph_capture_s")(plain) == 3.5
    monkeypatch.delattr(compiled, "captures")   # a program without it
    assert harness.reader("graph_capture_s")(plain) is None


@pytest.fixture
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_a_run_keeps_the_program_spans(few_threads):
    from tfnas_tpu_torch.utils import trace
    cell, cfg, tr = tiny.retrain("synth")
    man = harness.manifest()
    runs = []
    with spans.kept(runs):
        run = harness.run_on("cpu", cell, cfg, tr, 5, 0.2, trace=1)
    assert not trace.enabled() and harness.Run is not type(run)
    assert runs == [run] and harness.verdict(run.checks)
    rec = run.rec
    setup, window = rec.program["setup"], rec.program["window"]
    phases = ("tfnas.train.forward", "tfnas.train.backward",
              "tfnas.train.update")
    for name in phases:
        assert len(setup["host_ms"][name]) == 3   # the checked steps
        assert len(window["host_ms"][name]) == rec.counts["steps"]
    assert window["device_ms"] == {}   # no card
    assert isinstance(rec.trace["obj"], spans.SpanTrace)
    assert {s["name"] for s in rec.trace["obj"].program} == set(phases)
    assert spans.program_metrics(rec, "retrain.b256.synth") == {
        "dispatch_idle_share.train": pytest.approx(
            spans.idle_share_in(rec, "tfnas.train."))}
    assert spans.program_metrics(rec, "serve.b32.folded") == {}
    assert set(spans.idle_by_range(rec)) == set(phases)
    got = spans.summary(window)
    assert sorted(got) == sorted(phases)
    assert all(v[0] == rec.counts["steps"] and v[2] is None
               for v in got.values())
    # the harness reads what it reads without the spans kept
    plain = harness.run_on("cpu", cell, cfg, tr, 5, 0.2, trace=1)
    assert not hasattr(plain.rec, "program")
    assert set(harness.read_metrics(man, "retrain.b256.synth", 1, rec)) == \
        set(harness.read_metrics(man, "retrain.b256.synth", 1, plain.rec))
