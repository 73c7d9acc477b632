"""The serving cell: batch requests through a BN-folded eval network, as a
caller of the port runs it: `models/folding.fold_batchnorm`, then
`EvalNetwork.apply(training=False)` on bfloat16 inputs, replayed from one
CUDA graph by the port's `search/compiled.GraphedFn` (its counterpart of
`jax.jit`, under which the JAX package serves; eager on the CPU).

Set-up makes the weights from --seed (convolutions as in training, BN
scale and bias drawn around 1 and 0, running statistics calibrated on a
batch drawn from the seed so that every layer sees unit-scale
activations), folds them through the port, makes a pool of request
batches on the card, captures the forward (its one argument the batch;
the graph reads the folded weights in place) and warms it up. The window
is a closed loop: one request at a time (its batch copied into the
graph's input, the replay), timed from submission to its synchronize.
The check compares the logits of a sample of the window's requests,
drawn from the seed, with the plain reference's unfolded float32 forward
of the same weights and inputs.

Traffic parameters: batch_size, pool (request batches made at set-up,
cycled), warmup_requests, check_every (one request in this many is kept
for the check, from an offset drawn from the seed), trace_requests
(requests in the profiled section of a --trace 1 run). check_every and
pool have no common factor, so the kept requests cover every batch of
the pool.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..flops import evalnet_macs
from ..reference import lowp
from ..reference.evalnet import EvalNet
from ..reference.nn import BN, Pool, strict_float32
from .common import free_cuda, profiled, sync, trace_summary


def _bn_trees(params, state):
    """(params of each BN, its state) pairs of the eval net's trees."""
    out = []
    if isinstance(params, dict):
        if "bn" in params and isinstance(params["bn"], dict) and \
                "scale" in params["bn"]:
            out.append((params["bn"], state["bn"]))
        for k, v in params.items():
            if k != "bn" and isinstance(v, dict):
                out += _bn_trees(v, state.get(k, {}))
    return out


def make_weights(run, rnet, image_size, batch):
    """(params, bn_state) of a served net: training's init, BN scale in
    [0.5, 1.5) and bias in [-0.1, 0.1), running statistics of a forward in
    batch-statistics mode over a batch drawn from the seed."""
    pool = Pool(run.generator(1))
    params, state = rnet.init(pool)
    for p, _ in _bn_trees(params, state):
        p["scale"] = 0.5 + pool.rand(p["scale"].shape)
        p["bias"] = (pool.rand(p["bias"].shape) - 0.5) * 0.2
    g = run.generator(4)
    calib = torch.randn((batch, image_size, image_size, 3), generator=g,
                        device=run.device)
    prev = BN["momentum"]
    BN["momentum"] = 1.0
    try:
        with torch.no_grad():
            _, state = rnet.apply(params, state, calib, training=True)
    finally:
        BN["momentum"] = prev
    return params, state


def inputs(run, cfg, n, batch):
    """n request batches in the served dtype."""
    g = run.generator(2)
    s = cfg["image_size"]
    return torch.randn((n, batch, s, s, 3), generator=g,
                       device=run.device).to(getattr(torch, cfg["dtype"]))


def run(run):
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.models.folding import fold_batchnorm
    from tfnas_tpu_torch.search.compiled import AutoGraphed, SharedFamily

    cfg, tr, dev, rec = run.config, run.traffic, run.device, run.rec
    n, size = tr["batch_size"], cfg["image_size"]
    rnet = EvalNet(cfg["model_config"], cfg["num_classes"])
    params, state = make_weights(run, rnet, size, n)
    xs = inputs(run, cfg, tr["pool"], n)
    net = EvalNetwork.from_config(cfg["num_classes"], cfg["model_config"])
    fnet, fparams = fold_batchnorm(net, params, state)

    def forward(x):  # the graph reads the folded weights in place
        logits, _ = fnet.apply(fparams, {}, x, training=False)
        return (logits,)
    served = AutoGraphed(forward, {}, "serve", SharedFamily())

    def request(x):
        return served(x)[0]

    for i in range(tr["warmup_requests"]):
        request(xs[i % tr["pool"]])
    sync(dev)

    rng = np.random.default_rng(run.np_seed(5))
    every = tr["check_every"]
    offset = int(rng.integers(every))
    kept = {}
    lat = rec.latencies_ms
    t_start = time.perf_counter()
    rec.setup_s = t_start - run.t0
    t_end, i = t_start + run.seconds, 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        out = request(xs[i % tr["pool"]])
        sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        if i % every == offset:
            kept[i] = out.clone()
        i += 1
    rec.window_s = time.perf_counter() - t_start
    rec.counts.update(requests=i, attempted=i, images=i * n)
    rec.flops = 2.0 * evalnet_macs(rnet, size) * n * i
    if run.trace:
        from torch.profiler import record_function
        out = {}
        k = tr["trace_requests"]
        with profiled(dev, out):
            for j in range(k):  # the window's closed loop, in spans
                with record_function("bench.request"):
                    request(xs[j % tr["pool"]])
                with record_function("bench.sync"):
                    sync(dev)
        rec.trace = trace_summary(out["trace"])
        rec.trace.update(obj=out["trace"], requests=k)
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)

    del net, fnet, fparams, served
    free_cuda(dev)
    ref = reference_logits(run, rnet, params, state, xs,
                           sorted({j % tr["pool"] for j in kept}))
    gap = max(logit_gap(out, ref[j % tr["pool"]]) for j, out in kept.items())
    run.readings = {"logit_gap": gap}
    run.check("logit_gap", gap)


def logit_gap(out, ref):
    """The widest gap of a request's logits from the reference's, over the
    spread (standard deviation) of the reference's logits of its row."""
    ref = ref.double()
    return float(((out.double() - ref).abs().amax(dim=1)
                  / ref.std(dim=1)).max())


def reference_logits(run, rnet, params, state, xs, entries, mode=None):
    """{pool entry: float32 logits of the unfolded reference}; mode
    "float8": the control, in float8."""
    strict_float32()
    out = {}
    with torch.no_grad(), (lowp.float8() if mode == "float8"
                           else contextlib.nullcontext()):
        for j in entries:
            out[j], _ = rnet.apply(params, state, xs[j].float(),
                                   training=False)
    return out


def control(run, mode):
    """The logit gap of the reference in float8 put in the program's
    place, against the reference, over the whole request pool."""
    cfg, tr = run.config, run.traffic
    rnet = EvalNet(cfg["model_config"], cfg["num_classes"])
    params, state = make_weights(run, rnet, cfg["image_size"],
                                 tr["batch_size"])
    xs = inputs(run, cfg, tr["pool"], tr["batch_size"])
    entries = list(range(tr["pool"]))
    ref = reference_logits(run, rnet, params, state, xs, entries)
    side = reference_logits(run, rnet, params, state, xs, entries, mode)
    return {"logit_gap": max(logit_gap(side[j], ref[j]) for j in entries)}
