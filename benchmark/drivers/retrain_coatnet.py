"""The CoAtNet retrain cell: CoAtNet's training step on the port's normal
path (`EvalNetwork.from_config` of the configuration's model.config,
`parallel/train_dp.make_eval_steps(...).train_step`, replayed from one
CUDA graph on one card), on device-resident batches of random uint8
pixels made from --seed, cycled and normalised on the card; no loader.

Set-up makes the weights (the reference's draws, benchmark/reference/
coatnet.py) and the batches and runs the three steps the check holds
against the reference; the window runs the same loop for --seconds. A
--trace 1 run then profiles `trace_steps` replayed steps, and runs one
eager step (`capture=False`: the same kernels, dispatched op by op) with
the port's spans on, whose device times per block kind the per-layer
metrics read: rec.cuda_ms["tfnas.block.attn"] and
["tfnas.block.mbconv"] (ms a step, summed over the step's spans: each
block's forward and backward).

The check compares the first gradient and the change after the three
steps over the weights (the relative-bias tables left out), the first
step's change of the BN running statistics (`bn_diff`) and the first
gradient of the bias tables as a group of their own
(`grad_diff.rel_bias`), as the other retrain cell does
(benchmark/drivers/retrain.py).

Traffic parameters: batch_size, synth_batches, epoch (of the lr
schedule), trace_steps, limits.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import torch

from .. import compare
from ..flops_coatnet import coatnet_macs
from ..reference import augment, lowp
from ..reference import steps as rsteps
from ..reference.coatnet import CoAtNet, retrain_step
from ..reference.nn import Pool, strict_float32
from .common import (EventTimer, Throttle, clone_tree, free_cuda, profiled,
                     sync, trace_summary)
from .retrain import epoch_lr, hparams, reference_batches, synth_batches

SPANS = ("tfnas.block.attn", "tfnas.block.mbconv")
# the reference in a fault's place: the bias left out of the logits, or
# indexed by j - i for i - j
FAULTS = ("no_bias", "transposed")


def ref_net(cfg, fault=None):
    return CoAtNet(cfg["model_config"], cfg["num_classes"],
                   cfg["dropout_rate"], cfg["drop_connect_rate"], fault)


def groups_of(params):
    """The leaf order of the check (the weights, then the bias tables) as
    indices into compare.leaves(params), and its groups."""
    names = compare.paths(params)
    w = [i for i, p in enumerate(names) if not p.endswith("rel_bias")]
    b = [i for i, p in enumerate(names) if p.endswith("rel_bias")]
    return w + b, {"weights": slice(0, len(w)),
                   "rel_bias": slice(len(w), None)}


def readings(prog, ref, params):
    """The training numbers over the weights and over the bias tables, and
    bn_diff (as benchmark/drivers/retrain.py reads them)."""
    order, groups = groups_of(params)

    def ordered(side):
        return {"losses": side["losses"],
                "grads": [side["grads"][i] for i in order],
                "moved": [side["moved"][i] for i in order]}
    out = compare.training_readings(ordered(prog), ordered(ref), groups)
    out["bn_diff"] = float(compare.norm_of_diff(
        prog["bn_moved"], ref["bn_moved"], [slice(None)]).median())
    return out


def span_step(run, net, cfg, state, x, y, lr, keep):
    """Device ms of each block kind in one eager step, with the port's
    spans on (they record no event under a capture); {} where the
    program opens none of them."""
    from tfnas_tpu_torch.parallel.train_dp import make_eval_steps
    from tfnas_tpu_torch.utils import trace
    hp = hparams(cfg)
    eager, _ = make_eval_steps(
        net, num_classes=cfg["num_classes"], label_smooth=hp["label_smooth"],
        momentum=hp["momentum"], weight_decay=hp["weight_decay"],
        grad_clip=hp["grad_clip"], compute_dtype=getattr(torch, cfg["dtype"]),
        capture=False)
    eager(state, x, y, lr, keep)  # first-use caches
    sync(run.device)
    was = trace.enabled()
    trace.reset()
    trace.enable(blocks=True)
    try:
        eager(state, x, y, lr, keep)
        snap = trace.snapshot()
    finally:
        trace.reset()
        if was:
            trace.enable()
        else:
            trace.disable()
    return {name: [sum(ms)] for name, ms in snap["device_ms"].items()
            if name in SPANS}


def run(run):
    from tfnas_tpu_torch.data import device_normalizer
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.parallel.train_dp import (EvalTrainState,
                                                   make_eval_steps)

    cfg, tr, dev, rec = run.config, run.traffic, run.device, run.rec
    hp = hparams(cfg)
    lr = epoch_lr(cfg, tr["epoch"])
    rnet = ref_net(cfg)
    params, bn_state = rnet.init(Pool(run.generator(1)))
    net = EvalNetwork.from_config(cfg["num_classes"], cfg["model_config"],
                                  cfg["dropout_rate"],
                                  cfg["drop_connect_rate"])
    dtype = getattr(torch, cfg["dtype"])
    train_step, _ = make_eval_steps(
        net, num_classes=cfg["num_classes"], label_smooth=hp["label_smooth"],
        momentum=hp["momentum"], weight_decay=hp["weight_decay"],
        grad_clip=hp["grad_clip"], compute_dtype=dtype)
    state = EvalTrainState(clone_tree(params), clone_tree(bn_state),
                           rsteps.tree_map(torch.zeros_like, params), 0)
    xs, ys = synth_batches(run, cfg, tr)
    k_b = xs.shape[0]
    gen = run.generator(3)
    prep = device_normalizer(dtype)
    timer = EventTimer(dev)
    step_fn = timer.wrap("train_step", train_step) if run.trace \
        else train_step
    it = itertools.count()

    def step(state):
        i = next(it) % k_b
        keep = net.draw_keep(tr["batch_size"], gen)
        return step_fn(state, prep(xs[i]), ys[i], lr, keep)

    # -- set-up: the three steps the check follows ----------------------
    losses = []
    for k in range(3):
        state, m = step(state)
        losses.append(m["loss"].clone())
        if k == 0:
            grads = [mo - hp["weight_decay"] * p for mo, p in zip(
                compare.aligned(state.momentum, params),
                compare.leaves(params))]
            bn_moved = [a.float() - b for a, b in zip(
                compare.aligned(state.bn_state, bn_state),
                compare.leaves(bn_state))]
    moved = [a - b for a, b in zip(compare.aligned(state.params, params),
                                   compare.leaves(params))]
    prog = {"losses": [float(v) for v in losses], "grads": grads,
            "moved": moved, "bn_moved": bn_moved}
    sync(dev)

    # -- the window ---------------------------------------------------------
    throttle = Throttle(dev)
    timer.pairs.clear()
    t_start = time.perf_counter()
    rec.setup_s = t_start - run.t0
    t_end, n = t_start + run.seconds, 0
    while time.perf_counter() < t_end:
        throttle.step()
        state, m = step(state)
        n += 1
    sync(dev)
    rec.window_s = time.perf_counter() - t_start
    rec.counts.update(steps=n, attempted=n, images=n * tr["batch_size"])
    rec.flops = 3.0 * 2.0 * coatnet_macs(rnet, cfg["image_size"]) * \
        rec.counts["images"]
    rec.cuda_ms.update(timer.ms())
    if run.trace:
        out = {}
        with profiled(dev, out):
            for _ in range(tr["trace_steps"]):
                state, m = step(state)
        rec.trace = trace_summary(out["trace"])
        rec.trace.update(obj=out["trace"], steps=tr["trace_steps"])
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    if run.trace:
        # the graph's pool goes first: the eager step needs its own
        state = clone_tree(state)
        del train_step, step_fn, step
        free_cuda(dev)
        keep = net.draw_keep(tr["batch_size"], gen)
        rec.cuda_ms.update(span_step(run, net, cfg, state, prep(xs[0]),
                                     ys[0], lr, keep))

    # -- the check ----------------------------------------------------------
    del state, net
    free_cuda(dev)
    ref = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr)
    run.readings = readings(prog, ref, params)
    run.detail = compare.top_leaves(prog, ref, compare.paths(params))
    for name in tr["limits"]:  # a number not read fails
        run.check(name, run.readings.get(name, float("nan")))


def reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                    mode=None):
    """The three checked steps through the plain reference in float32
    (TF32 off) on the same batches, with the program's draws; mode
    "float8": the control; a FAULTS mode: that fault's reference."""
    strict_float32()
    gen = run.generator(3)
    if mode in FAULTS:
        rnet = ref_net(cfg, mode)
    p, s = clone_tree(params), clone_tree(bn_state)
    mom = rsteps.tree_map(torch.zeros_like, p)
    losses = []
    ctx = lowp.float8() if mode == "float8" else contextlib.nullcontext()
    with ctx:
        for k, (x, y) in enumerate(reference_batches(run, cfg, tr)):
            keep = rnet.draw_keep(x.shape[0], gen)
            p, s, mom, loss = retrain_step(rnet, p, s, mom,
                                           augment.normalize(x), y, lr, keep,
                                           hp=hp)
            losses.append(float(loss))
            if k == 0:
                grads = [m - hp["weight_decay"] * q for m, q in zip(
                    rsteps.leaves(mom), rsteps.leaves(params))]
                bn_moved = [a - b for a, b in zip(
                    compare.aligned(s, bn_state), compare.leaves(bn_state))]
    return {"losses": losses, "grads": grads, "bn_moved": bn_moved,
            "moved": [a - b for a, b in zip(rsteps.leaves(p),
                                            rsteps.leaves(params))]}


def control(run, mode):
    """The compared numbers of the reference put in the program's place,
    in `mode` (float8, or one of FAULTS), against the reference."""
    cfg, tr = run.config, run.traffic
    hp = hparams(cfg)
    lr = epoch_lr(cfg, tr["epoch"])
    rnet = ref_net(cfg)
    params, bn_state = rnet.init(Pool(run.generator(1)))
    ref = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr)
    side = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                           mode=mode)
    return readings(side, ref, params)
