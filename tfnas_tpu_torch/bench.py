"""Search and inference throughput of the port on one card (counterpart of
the repository's bench.py).

    python -m tfnas_tpu_torch.bench [--deadline 900]

1. search: steady-state weight steps per second in bench.py's schedule, a
   bi-sampling weight step every iteration and a soft arch step every
   second one, at batch 32, 224^2, bf16, against latency_pkl/latency_tpu.pkl
   (ImageNet-100 shapes). It runs eagerly and from CUDA graphs in turns
   (eager, captured, captured, eager) in one process; graph capture happens
   in the untimed warm-up iterations.
2. eval: TF-NAS-A (configs/tfnas_a_tpu.config) BN-folded bf16 inference
   images per second at batch 256, as a chain of dependent forwards in one
   CUDA graph (cost/measure.py), for the folded network and for its
   space-to-depth stem.

Each phase prints one JSON line when it ends; the last line is bench.py's
summary: {"metric", "value", "unit", "vs_baseline", "secondary"}, with
`vs_baseline` against the reference's 1.85 weight steps/s (90 epochs x
3192 weight steps in 1.8 Titan RTX days). The run has a deadline: a phase
that would pass it is cut, its line says so, and the summary still prints
(with "complete": false; the exit code is then 3).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .cost.lut import (build_space_analytic_lut, lat_vectors_for_mc,
                       load_lat_lookup)
from .device import resolve_device
from .models import hybrid_space as hs
from .models import search_space as ss
from .models.supernet import SuperNetwork
from .models.supernet_hybrid import HybridSuperNetwork
from .search.bisample import (gumbel_uniform, sample_gumbel_indices,
                              sample_random_excluding)
from .search.compiled import GraphFamily
from .search.parser import get_mc_num_dddict
from .search.train_step import adam_init, make_search_steps, zeros_like_tree

BASELINE_STEPS_PER_SEC = 287316.0 / (1.8 * 24 * 3600)  # 1.847
BASELINE_EVAL_IMS = 32 / 0.01803  # TF-NAS-A on a Titan RTX at batch 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cut(Exception):
    """The run's deadline passed inside a phase."""


class Deadline:
    def __init__(self, seconds):
        self.end = time.perf_counter() + seconds

    def check(self):
        if time.perf_counter() > self.end:
            raise Cut()


def emit(obj):
    print(json.dumps(obj), flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def search_setup(device, space=None, batch=32, size=224, ncls=100,
                 lut_path=None, hybrid=False, **net_kw):
    """The supernet, its state on `device` and one batch, as bench.py
    builds them: the MBConv supernet over `space` (the full space when
    None) or, with `hybrid`, the hybrid conv/ViT one. lut_path: the
    latency table (latency_pkl/latency_tpu.pkl, or its hybrid counterpart,
    by default). net_kw: SuperNetwork's lowering flags."""
    if hybrid:
        sp, net = hs, HybridSuperNetwork(ncls, **net_kw)
    else:
        sp, net = space or ss, SuperNetwork(ncls, space=space, **net_kw)
    if lut_path is None:
        lut_path = os.path.join(ROOT, "latency_pkl", "latency_tpu_hybrid.pkl"
                                if hybrid else "latency_tpu.pkl")
    gen = torch.Generator(device=device).manual_seed(0)
    params, arch = net.init(gen)
    mc_mask = sp.build_mc_mask_dddict()
    if space is None:
        lut = load_lat_lookup(lut_path)
    else:
        lut = build_space_analytic_lut(space)
    lat = lat_vectors_for_mc(lut, get_mc_num_dddict(mc_mask),
                             sp.build_lat_lookup_key_dddict(), sp.NUM_OPS)
    target = float(lat.max(1).sum() + lut["base"]) * 0.6
    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = {
        "params": params, "arch": arch, "mom": zeros_like_tree(params),
        "opt": adam_init(arch), "masks": net.device_masks(mc_mask, device),
        "umasks": net.update_masks(params, mc_mask),
        "lat": torch.from_numpy(lat).to(device),
        "base": torch.tensor(float(lut["base"]), device=device),
        "lr": torch.tensor(0.025, device=device),
        "T": torch.tensor(5.0, device=device),
        "x": torch.from_numpy(rng.standard_normal(
            (batch, size, size, 3), np.float32)).to(device, dtype),
        "y": torch.from_numpy(rng.integers(0, ncls, batch)).to(device)}
    return net, state, target, gen


def weight_iter(steps, st, gen, valid=None):
    """One bi-sampling weight step on the state dict `st` (updated in
    place), its two draws from `gen` over the `valid` candidates; returns
    its metrics."""
    la = st["arch"]["log_alphas"]
    ig = sample_gumbel_indices(la, gen, valid)
    ir = sample_random_excluding(ig, la.shape[-1], gen, valid)
    st["params"], st["mom"], m = steps.weight_step(
        st["params"], st["arch"], st["mom"], st["masks"], st["umasks"],
        st["x"], st["y"], st["lr"], ig, ir)
    return m


def arch_iter(steps, st, gen):
    """One soft arch step on `st` (updated in place); returns its
    metrics."""
    st["arch"], st["opt"], m = steps.arch_step(
        st["params"], st["arch"], st["opt"], st["masks"], st["x"], st["y"],
        st["lat"], st["base"], st["T"],
        gumbel_uniform(st["arch"]["log_alphas"].shape, gen))
    return m


def search_iter(steps, st, gen, i):
    """Iteration i of bench.py's schedule: a weight step, then an arch
    step when i is even; returns the weight step's metrics."""
    m = weight_iter(steps, st, gen)
    if i % 2 == 0:
        arch_iter(steps, st, gen)
    return m


def search_rate(net, state, target, gen, capture, n_timed, warm, deadline,
                family=None):
    """Weight steps per second over n_timed iterations after `warm`."""
    steps = make_search_steps(net, num_classes=net.num_classes,
                              target_lat=target, capture=capture,
                              family=family)
    st = dict(state)
    if family is not None:
        st = family.adopt(st)
    device = st["x"].device

    t = time.perf_counter()
    for i in range(warm):
        m = search_iter(steps, st, gen, i)
        deadline.check()
    _sync(device)
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(n_timed):
        m = search_iter(steps, st, gen, i)
        deadline.check()
    loss = float(m["loss"])  # waits for the last step
    dt = time.perf_counter() - t
    return n_timed / dt, warm_s, loss


def eval_rates(device, batch, image_size, iters, deadline):
    """TF-NAS-A folded (and folded + space-to-depth stem) bf16 forwards:
    images per second from the chained, captured forward."""
    from .cost.measure import measure_latency_in_ms
    from .models.eval_net import EvalNetwork
    from .models.folding import fold_batchnorm, fold_stem_space_to_depth
    from .search.train_step import tree_map

    with open(os.path.join(ROOT, "configs", "tfnas_a_tpu.config")) as f:
        net = EvalNetwork.from_config(1000, json.load(f))
    params, state = net.init(torch.Generator(device=device).manual_seed(0))
    folded, fparams = fold_batchnorm(net, params, state)
    s2d, sparams = fold_stem_space_to_depth(folded, fparams)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, image_size, image_size, 3), np.float32)).to(device, dtype)
    rates = {}
    for name, (n, p) in (("folded", (folded, fparams)),
                         ("s2d", (s2d, sparams))):
        deadline.check()
        p = tree_map(lambda t: t.to(dtype), p)
        ms = measure_latency_in_ms(
            lambda pp, xx, n=n: n.apply(pp, {}, xx, training=False)[0],
            (p, x), warmup=iters, iters=iters)
        rates[name] = batch / ms * 1e3
    return rates


parser = argparse.ArgumentParser("port bench")
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--deadline', type=float, default=900.0,
                    help='seconds; a phase still running then is cut')
parser.add_argument('--space', choices=['mbconv', 'tiny'], default='mbconv')
parser.add_argument('--batch_size', type=int, default=32)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--num_classes', type=int, default=100)
parser.add_argument('--n_timed', type=int, default=40)
parser.add_argument('--warm', type=int, default=8)
parser.add_argument('--eval_batch', type=int, default=256)
parser.add_argument('--eval_iters', type=int, default=20)


def main(argv=None):
    args = parser.parse_args(argv)
    deadline = Deadline(args.deadline)
    device = resolve_device(args.device)
    space = (ss.tiny_space(args.image_size) if args.space == 'tiny'
             else None)
    complete = True
    rates = {"eager": [], "captured": []}
    modes = ["eager", "captured", "captured", "eager"]
    if device.type != "cuda":
        modes = ["eager", "eager"]  # no graphs off the card
    try:
        net, state, target, gen = search_setup(
            device, space, args.batch_size, args.image_size,
            args.num_classes)
        family = GraphFamily(device) if device.type == "cuda" else None
        for mode in modes:
            rec = {"phase": "search", "mode": mode,
                   "batch": args.batch_size, "image_size": args.image_size}
            try:
                rate, warm_s, loss = search_rate(
                    net, state, target, gen, mode == "captured",
                    args.n_timed, args.warm, deadline,
                    family if mode == "captured" else None)
            except Cut:
                emit(dict(rec, cut=True))
                raise
            rates[mode].append(rate)
            emit(dict(rec, weight_steps_per_s=rate,
                      ms_per_weight_step=1e3 / rate, warm_s=warm_s,
                      loss=loss, finite=math.isfinite(loss)))
        del state, family
        if device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            ev = eval_rates(device, args.eval_batch, args.image_size,
                            args.eval_iters, deadline)
        except Cut:
            emit({"phase": "eval", "cut": True})
            raise
        emit({"phase": "eval", "batch": args.eval_batch,
              "images_per_s": ev})
    except Cut:
        complete, ev = False, {}
    done = rates["captured"] or rates["eager"]
    value = float(np.median(done)) if done else None
    eval_value = max(ev.values()) if ev else None
    summary = {
        "metric": "supernet_search_weight_steps_per_sec",
        "value": value, "unit": "steps/sec",
        "vs_baseline": (value / BASELINE_STEPS_PER_SEC if value else None),
        "modes": rates,
        "secondary": {
            "metric": "tfnas_a_eval_images_per_sec_per_chip",
            "value": eval_value, "unit": "images/sec",
            "vs_baseline": (eval_value / BASELINE_EVAL_IMS
                            if eval_value else None),
            "serving_graphs": ev},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "complete": complete}
    emit(summary)
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["complete"] else 3)
