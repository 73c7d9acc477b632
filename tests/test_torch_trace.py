"""The port's spans (tfnas_tpu_torch/utils/trace.py) on the CPU: off they
are one shared null context that builds, keeps and records nothing and
calls nothing of torch; on they nest per thread with their parents and
ids and lie in the profiler's trace; the eager train step records its
forward, backward and update once a step and computes the same state bit
for bit as with tracing off."""

import threading
import tracemalloc
from collections import OrderedDict

import pytest
import torch

from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.eval_net import EvalNetwork
from tfnas_tpu_torch.parallel import train_dp
from tfnas_tpu_torch.search.parser import get_mc_num_dddict
from tfnas_tpu_torch.search.train_step import tree_leaves
from tfnas_tpu_torch.utils import trace


@pytest.fixture
def tracing():
    """Tracing on for the test, off and empty after it."""
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _refuse(*a, **k):
    raise AssertionError("tracing off called into torch")


def test_off_is_one_null_context_that_records_nothing(monkeypatch):
    assert not trace.enabled()
    trace.reset()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", _refuse)
    monkeypatch.setattr(trace.Span, "__init__", _refuse)  # builds nothing
    for _ in range(3):
        s = trace.span("tfnas.test", device=True, graph="g")
        assert s is trace.NULL
        with s as entered:
            assert entered is None
    assert trace.snapshot() == {"host_ms": {}, "device_ms": {}, "spans": []}


def test_off_keeps_nothing_per_span():
    def spans(n):
        for _ in range(n):
            with trace.span("tfnas.test", graph="g"):
                with trace.span("tfnas.test.inner", device=True):
                    pass
    spans(100)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        spans(20000)
        kept = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    # 40,000 spans: one 56-byte object kept for each would be 2.2 MB
    assert kept < 64 * 1024
    assert trace.snapshot()["spans"] == []


def test_clock_measures_off_and_is_recorded_on(tracing):
    trace.disable()
    with trace.clock("tfnas.test.off") as c:
        pass
    assert c.ms >= 0 and trace.snapshot()["spans"] == []
    trace.enable()
    with trace.clock("tfnas.test.on", graph="g") as c:
        pass
    snap = trace.snapshot()
    assert snap["host_ms"] == {"tfnas.test.on": [c.ms]}
    assert snap["spans"][0]["ids"] == {"graph": "g"}


def test_nesting_parents_ids_and_threads(tracing):
    entered = []

    def worker(tag, barrier):
        with trace.span("tfnas.test.outer", worker=tag) as outer:
            barrier.wait(timeout=10)   # both threads inside their outer span
            with trace.span("tfnas.test.inner", worker=tag) as inner:
                entered.append((tag, outer, inner))
            barrier.wait(timeout=10)

    barrier = threading.Barrier(2)
    threads = [threading.Thread(target=worker, args=(t, barrier))
               for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(e[0] for e in entered) == ["a", "b"]
    for tag, outer, inner in entered:
        assert outer.parent is None and inner.parent is outer
        assert inner.ids == {"worker": tag} and inner.thread == outer.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    snap = trace.snapshot()
    assert len(snap["spans"]) == 4
    assert {s["thread"] for s in snap["spans"]} == \
        {e[1].thread for e in entered}
    for s in snap["spans"]:
        want = "tfnas.test.outer" if s["name"] == "tfnas.test.inner" \
            else None
        assert s["parent"] == want
    assert sorted(snap["host_ms"]) == ["tfnas.test.inner", "tfnas.test.outer"]
    assert all(len(v) == 2 and min(v) >= 0 for v in snap["host_ms"].values())
    # no CUDA on the CPU: no device times
    assert snap["device_ms"] == {}
    trace.reset()
    assert trace.snapshot()["spans"] == []


def test_spans_lie_in_the_profiler_trace(tracing, tmp_path):
    """Inside a profiler session each span is a range of the Chrome trace
    on the profiler's clock, nested as the spans are."""
    import json
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("tfnas.test.a"):
            with trace.span("tfnas.test.b"):
                torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("name", "").startswith("tfnas.test.")}
    a, b = events["tfnas.test.a"], events["tfnas.test.b"]
    assert a["cat"] == b["cat"] == "cpu_op"
    assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]


def _tiny_train_step():
    sp = tss.tiny_space(32)
    parsed = OrderedDict(
        (st, OrderedDict((b, (i + 3) % 8)
                         for i, b in enumerate(sp.block_names(st))))
        for st in sp.STAGE_NAMES)
    mc = get_mc_num_dddict(sp.build_mc_mask_dddict())
    net = EvalNetwork.from_parsed_arch(10, parsed, mc, 0.2, 0.2, space=sp)
    state = train_dp.init_eval_train_state(
        net, torch.Generator().manual_seed(3))
    step, _ = train_dp.make_eval_steps(net, num_classes=10,
                                       compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(4, 32, 32, 3, generator=g),
                torch.randint(0, 10, (4,), generator=g)) for _ in range(2)]
    return net, state, step, batches


def _run(net, state, step, batches):
    g = torch.Generator().manual_seed(5)
    for x, y in batches:
        state, m = step(state, x, y, 0.1, net.draw_keep(len(y), g))
    return state, m


def test_train_step_traced_equals_untraced_and_records_phases():
    net, state, step, batches = _tiny_train_step()
    trace.reset()
    off, m_off = _run(net, state, step, batches)
    assert trace.snapshot()["spans"] == []
    trace.enable()
    try:
        on, m_on = _run(net, state, step, batches)
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    def flat(st, m):
        return [l for t in st[:3] for l in tree_leaves(t)] + list(m.values())
    got, want = flat(on, m_on), flat(off, m_off)
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    phases = ["tfnas.train.forward", "tfnas.train.backward",
              "tfnas.train.update"]
    assert [s["name"] for s in snap["spans"]] == phases * len(batches)
    assert all(s["parent"] is None for s in snap["spans"])
    assert sorted(snap["host_ms"]) == sorted(phases)


def _coatnet_step():
    """A small CoAtNet (two stems, MBConv blocks, transformer blocks) and
    its eager train step."""
    from benchmark.reference import coatnet as rc
    cfg = rc.model_config((2, 1, 1, 2, 1), (16, 16, 32, 64, 64), 32, 10)
    net = EvalNetwork.from_config(10, cfg, 0.2, 0.2)
    state = train_dp.init_eval_train_state(
        net, torch.Generator().manual_seed(3))
    step, _ = train_dp.make_eval_steps(net, num_classes=10,
                                       compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(4, 32, 32, 3, generator=g),
                torch.randint(0, 10, (4,), generator=g))]
    return net, state, step, batches


def test_coatnet_block_and_attention_spans(tracing):
    """With the block spans on, a CoAtNet's eager step opens one
    `tfnas.block.mbconv` span per stem and MBConv block and one
    `tfnas.block.attn` per transformer block in the forward, and one
    `tfnas.attn.core` inside each attention block; in the backward the
    same block spans in reverse order, each opening where the one before
    closes, the last closing inside the backward's span."""
    net, state, step, batches = _coatnet_step()
    trace.enable(blocks=True)
    _run(net, state, step, batches)
    spans = trace.snapshot()["spans"]
    order = ["tfnas.block.mbconv"] * 4 + ["tfnas.block.attn"] * 3
    fwd = [s for s in spans if s["parent"] == "tfnas.train.forward"]
    assert [s["name"] for s in fwd] == order
    bwd = [s for s in spans if s["parent"] == "tfnas.train.backward"]
    assert [s["name"] for s in bwd] == order[::-1]
    for a, b in zip(bwd, bwd[1:]):
        assert a["end_ns"] <= b["start_ns"]
    (whole,) = [s for s in spans if s["name"] == "tfnas.train.backward"]
    assert whole["start_ns"] <= bwd[0]["start_ns"]
    assert bwd[-1]["end_ns"] <= whole["end_ns"]
    core = [s["parent"] for s in spans if s["name"] == "tfnas.attn.core"]
    assert core == ["tfnas.block.attn"] * 3
    assert not trace._backward  # every backward span closed


@pytest.mark.parametrize("blocks", [False, True])
def test_block_spans_open_only_when_asked_for(tracing, blocks):
    """Tracing on without the block spans, a CoAtNet's eager step records
    the phases alone (they stay the innermost spans); with them, the
    phases as before and the block spans inside; the state is the same
    bit for bit either way."""
    net, state, step, batches = _coatnet_step()
    trace.enable(blocks=blocks)
    on, _ = _run(net, state, step, batches)
    names = {s["name"] for s in trace.snapshot()["spans"]}
    phases = {"tfnas.train.forward", "tfnas.train.backward",
              "tfnas.train.update"}
    fine = {"tfnas.block.mbconv", "tfnas.block.attn", "tfnas.attn.core"}
    assert names == (phases | fine if blocks else phases)
    trace.disable()
    off, _ = _run(net, state, step, batches)
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("make", [_tiny_train_step, _coatnet_step],
                         ids=["tfnas", "coatnet"])
def test_new_call_sites_off_record_nothing(monkeypatch, make):
    """Tracing off, the block and attention call sites build no span,
    register no hook, call nothing of the profiler or CUDA's events, and
    leave the snapshot empty."""
    net, state, step, batches = make()
    assert not trace.enabled()
    trace.reset()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", _refuse)
    monkeypatch.setattr(trace.Span, "__init__", _refuse)
    _run(net, state, step, batches)
    assert trace.snapshot() == {"host_ms": {}, "device_ms": {}, "spans": []}
