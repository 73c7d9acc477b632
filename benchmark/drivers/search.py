"""The search cell: the port's bi-level supernet search after its warm-up
epochs, as `tfnas_tpu_torch.train_search` runs it on the card.

Set-up makes the supernet's weights, the train and val batches (device
tensors, cycled) and the latency table's vectors from the configuration
and --seed, builds one `Search` over a `GraphFamily` (every step replayed
from a CUDA graph), opens the epoch (`begin_epoch`) and drives
`Search.train_epoch` through its first three steps (weight step 0, arch
step 0, weight step 1: the captures and the warm-up). The window hands the
same object the next batches through `train_epoch` for --seconds: a
weight step per batch, an arch step after weight steps 0, 2, 4, ... of the
call. The check holds the three set-up steps against the plain reference.

Traffic parameters: epoch (the search epoch whose lr and T the window
runs at), train_batches, val_batches (batches made at set-up),
trace_steps (weight steps in the profiled section of a --trace 1 run).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from collections import OrderedDict

import torch

from .. import compare
from ..flops import SupernetMacs
from ..harness import ROOT
from ..reference import draws as rdraws
from ..reference import lowp
from ..reference import steps as rsteps
from ..reference.nn import Pool, strict_float32
from ..reference.supernet import SuperNet, Space, lat_vectors, load_lut
from .common import (EventTimer, Throttle, clone_tree, free_cuda, profiled,
                     sync, timed_batches, trace_summary)


def hparams(cfg):
    return {k: cfg[k] for k in (
        "w_mom", "w_wd", "a_lr", "a_beta1", "a_beta2", "a_wd", "grad_clip",
        "lambda_lat", "target_lat", "lat_under_boost")}


def epoch_lr_T(cfg, epoch):
    """The epoch's lr (closed-form cosine over the search's epochs) and
    temperature (decayed after every bi-level epoch before it)."""
    lr = cfg["w_lr"] * (1 + math.cos(math.pi * epoch / cfg["epochs"])) / 2
    T = cfg["T"] * cfg["T_decay"] ** max(0, epoch - cfg["warmup_epochs"])
    return lr, T


class RecordingDraws:
    """The driver's draws, with every pick kept (for the check and the
    FLOPs of the sampled paths)."""

    def __init__(self, draws):
        self.draws, self.picks = draws, []

    def gumbel(self, log_alphas):
        idx = self.draws.gumbel(log_alphas)
        self.picks.append(["g", idx.clone()])
        return idx

    def partner(self, idx_g, num_ops):
        idx = self.draws.partner(idx_g, num_ops)
        self.picks.append(["r", idx.clone()])
        return idx

    def uniform(self, shape):
        return self.draws.uniform(shape)

    def pairs(self):
        """[(idx_g, idx_r)] of the weight steps, in order."""
        g = [p[1] for p in self.picks if p[0] == "g"]
        r = [p[1] for p in self.picks if p[0] == "r"]
        return list(zip(g, r))


def program_space(cfg):
    from tfnas_tpu_torch.models import search_space as ss
    sp = cfg["space"]
    return ss.make_space(
        OrderedDict((k, dict(v)) for k, v in sp["stages"].items()),
        stem_conv=sp["stem_conv"], second_stem=sp["second_stem"],
        head_conv=sp["head_conv"], head_features=sp["head_features"],
        input_size=cfg["image_size"])


def make_inputs(run, cfg, tr):
    """(reference net, weights, arch params, mc masks, LUT, train batches,
    val batches) of the run's seed."""
    dev = run.device
    rspace = Space(cfg["space"], cfg["image_size"])
    rnet = SuperNet(rspace, cfg["num_classes"])
    params, arch = rnet.make_params(Pool(run.generator(1)))
    lut = load_lut(ROOT / cfg["lut"])
    g = run.generator(2)
    n, s, c = cfg["batch_size"], cfg["image_size"], cfg["num_classes"]
    dtype = getattr(torch, cfg["dtype"])

    def batches(k):
        x = torch.randn((k, n, s, s, 3), generator=g, device=dev)
        y = torch.randint(0, c, (k, n), generator=g, device=dev)
        return x.to(dtype), y
    return (rnet, params, arch, rspace.mc_mask_dddict(), lut,
            batches(tr["train_batches"]), batches(tr["val_batches"]))


def run(run):
    from tfnas_tpu_torch.data import device_normalizer
    from tfnas_tpu_torch.models.supernet import SuperNetwork
    from tfnas_tpu_torch.search.compiled import GraphFamily
    from tfnas_tpu_torch.train_search import GeneratorDraws, Search

    cfg, tr, dev = run.config, run.traffic, run.device
    rec = run.rec
    rnet, params, arch, mc, lut, (xs, ys), (xv, yv) = make_inputs(run, cfg,
                                                                   tr)
    hp = hparams(cfg)
    lr, T = epoch_lr_T(cfg, tr["epoch"])
    sp = program_space(cfg)
    net = SuperNetwork(cfg["num_classes"], space=sp)
    family = GraphFamily(dev) if dev.type == "cuda" else None
    search = Search(net, sp, lut, clone_tree(params), clone_tree(arch), mc,
                    dev, step_kwargs=dict(num_classes=cfg["num_classes"],
                                          **hp), family=family)
    draws = GeneratorDraws(run.generator(3))
    rdraw = RecordingDraws(draws)
    prep = device_normalizer(getattr(torch, cfg["dtype"]))
    kt, kv = xs.shape[0], xv.shape[0]
    nval = itertools.count()

    def arch_batches():
        for i in nval:
            yield xv[i % kv], yv[i % kv]

    def train_batches(start):
        for i in itertools.count(start):
            yield xs[i % kt], ys[i % kt]

    search.begin_epoch(lr, T)

    # -- set-up: the first three steps, kept for the check --------------
    losses, grads = [], {}
    orig_w, orig_a = search.weight_step, search.arch_step

    def keep_w(x, y, d):
        m = orig_w(x, y, d)
        losses.append(m["loss"].clone())
        return m

    def keep_a(x, y, d):
        m = orig_a(x, y, d)
        losses.append(m["loss_a"].clone())
        return m

    def check_batches():
        yield xs[0], ys[0]
        # weight step 0 and arch step 0 have run: their gradients as the
        # optimisers got them, from their state
        grads["w"] = [m - hp["w_wd"] * p for m, p in zip(
            compare.aligned(search.mom, params), compare.leaves(params))]
        grads["a"] = [mu / (1 - hp["a_beta1"]) - hp["a_wd"] * a
                      for mu, a in zip(compare.aligned(search.opt_a.mu, arch),
                                       compare.leaves(arch))]
        yield xs[1], ys[1]

    search.weight_step, search.arch_step = keep_w, keep_a
    search.train_epoch(check_batches(), arch_batches, rdraw, False, prep)
    search.weight_step, search.arch_step = orig_w, orig_a
    moved = [a.float() - b for a, b in zip(
        compare.aligned(search.params, params)
        + compare.aligned(search.arch_params, arch),
        compare.leaves(params) + compare.leaves(arch))]
    prog_losses = [float(l) for l in losses]
    picks = [(g.cpu(), r.cpu()) for g, r in rdraw.pairs()]
    sync(dev)

    # -- the window -------------------------------------------------------
    counter = {"n": 0}
    throttle = Throttle(dev)
    if not run.trace:
        t_start = time.perf_counter()
        rec.setup_s = t_start - run.t0
        search.train_epoch(timed_batches(train_batches(2), run.seconds,
                                         throttle, counter),
                           arch_batches, draws, False, prep,
                           log=lambda *a: None)
        sync(dev)
        rec.window_s = time.perf_counter() - t_start
        nw = counter["n"]
        rec.counts.update(weight_steps=nw, arch_steps=(nw + 1) // 2,
                          attempted=nw)
        rec.counts["images"] = nw * cfg["batch_size"]
    else:
        traced_window(run, search, draws, arch_batches, train_batches,
                      prep, rnet, mc)
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)

    # -- the check ----------------------------------------------------------
    del search, family, net, orig_w, orig_a
    free_cuda(dev)
    ref = reference_steps(run, rnet, params, arch, mc, lut, xs, ys, xv, yv,
                          picks, hp, lr, T)
    prog = {"pick_mismatch": ref["pick_mismatch"], "losses": prog_losses,
            "grads": grads["w"] + grads["a"], "moved": moved}
    run.readings = readings(prog, ref)
    for name in run.traffic["limits"]:  # a number not read fails
        run.check(name, run.readings.get(name, float("nan")))
    run.detail = detail(prog, ref, params, arch)
    run.leaf_gaps = leaf_gaps(prog, ref)


def traced_window(run, search, draws, arch_batches, train_batches, prep,
                  rnet, mc):
    """A --trace 1 run: the window with CUDA events around every step
    and the picks kept, then a profiled section of trace_steps weight
    steps."""
    cfg, tr, dev, rec = run.config, run.traffic, run.device, run.rec
    timer = EventTimer(dev)
    rdraw = RecordingDraws(draws)
    search.weight_step = timer.wrap("weight_step", search.weight_step)
    search.arch_step = timer.wrap("arch_step", search.arch_step)
    counter = {"n": 0}
    t_start = time.perf_counter()
    rec.setup_s = t_start - run.t0
    search.train_epoch(timed_batches(train_batches(2), run.seconds,
                                     Throttle(dev), counter),
                       arch_batches, rdraw, False, prep,
                       log=lambda *a: None)
    sync(dev)
    rec.window_s = time.perf_counter() - t_start
    nw = counter["n"]
    rec.counts.update(weight_steps=nw, arch_steps=(nw + 1) // 2,
                      attempted=nw, images=nw * cfg["batch_size"])
    rec.cuda_ms.update(timer.ms())
    macs = SupernetMacs(rnet, mc)
    n = cfg["batch_size"]
    rec.flops = (sum(macs.weight_step(g, r, n) for g, r in rdraw.pairs())
                 + rec.counts["arch_steps"] * macs.arch_step(n))

    steps = tr["trace_steps"]
    out = {}
    with profiled(dev, out):
        search.train_epoch(itertools.islice(train_batches(2 + nw), steps),
                           arch_batches, draws, False, prep,
                           log=lambda *a: None)
    trace = out["trace"]
    rec.trace = trace_summary(trace)
    rec.trace["obj"] = trace
    na = (steps + 1) // 2
    if not rec.peaks:  # no peak rates of this device: no roofline
        return
    rec.bounds["fused_dw"] = {
        "launches": 2 * len(rnet.space.sites) * steps
        + len(rnet.space.sites) * na,
        "bound_s": steps * fused_bound_s(rnet, n, "sampled", rec.peaks)
        + na * fused_bound_s(rnet, n, "soft", rec.peaks)}


def fused_bound_s(rnet, n, path, peaks):
    """The least time of the fused depthwise launches of one step's
    forward (a pair of sampled paths: two per block; soft: one per block
    over all 8 candidates' 6 W channels): each input byte read once,
    each output byte written once at the memory rate, against the 25
    multiply-adds per output and the prologue at the f32 rate (the port's
    chip_smoke.py `_bound`, bf16 activations)."""
    total = 0.0
    for s in rnet.space.sites:
        c = s.width if path == "sampled" else 6 * s.width
        ho = (s.res - 1) // s.stride + 1
        x, out = n * s.res * s.res * c, n * ho * ho * c
        nbytes = x * 2 + 25 * c * 4 + 2 * c * 4 + out * 2 + 2 * c * 4
        flops = 2 * 25 * out + 4 * x
        t = max(nbytes / peaks["hbm_bytes_per_s"],
                flops / peaks["f32_flops_per_s"])
        total += t * (2 if path == "sampled" else 1)
    return total


def reference_steps(run, rnet, params, arch, mc, lut, xs, ys, xv, yv,
                    picks, hp, lr, T, mode=None):
    """The set-up's three steps through the plain reference in float32
    (TF32 off), from the same weights, batches and draws: weight step 0
    on the picks the reference draws itself from the initial log_alphas
    (compared with the program's: pick_mismatch), arch step 0, weight
    step 1 on the program's picks (drawn from the program's arch state;
    with picks None, on its own). mode "float8": the control, in float8;
    "half_batch": a fault, each step on the first half of its batch;
    "float64": the same steps in float64 (for the look into which leaves
    amplify rounding)."""
    strict_float32()
    dev = run.device
    half = (lambda t: t[:t.shape[0] // 2]) if mode == "half_batch" else (
        lambda t: t)
    f32 = torch.float64 if mode == "float64" else torch.float32
    g = run.generator(3)
    masks = rnet.masks(mc, dev)
    um = rnet.update_masks(params, masks)
    lat = torch.from_numpy(lat_vectors(lut, rnet.space, mc)).to(dev, f32)
    base = torch.tensor(float(lut["base"]), device=dev, dtype=f32)
    p, a = (rsteps.tree_map(lambda t: t.to(f32), clone_tree(params)),
            rsteps.tree_map(lambda t: t.to(f32), clone_tree(arch)))
    mom = rsteps.tree_map(torch.zeros_like, p)
    opt = rsteps.adam_init(a)
    with (lowp.float8() if mode == "float8" else contextlib.nullcontext()):
        ig = rdraws.gumbel_pick(a["log_alphas"], g)
        ir = rdraws.partner(ig, 8, g)
        own = [(ig.cpu(), ir.cpu())]
        mismatch = (0 if picks is None else
                    int((own[0][0] != picks[0][0]).sum()
                        + (own[0][1] != picks[0][1]).sum()))
        p, mom, l0 = rsteps.weight_step(
            rnet, p, a, mom, masks, um, half(xs[0]).to(f32), half(ys[0]),
            lr, ig, ir, hp=hp)
        gw = [m - hp["w_wd"] * q for m, q in zip(
            rsteps.leaves(mom), rsteps.leaves(params))]
        u = rdraws.uniform(a["log_alphas"].shape, g)
        a, opt, la = rsteps.arch_step(
            rnet, p, a, opt, masks, half(xv[0]).to(f32), half(yv[0]), lat,
            base, T, u, hp=hp)
        ga = [mu / (1 - hp["a_beta1"]) - hp["a_wd"] * q
              for mu, q in zip(rsteps.leaves(opt["mu"]),
                               rsteps.leaves(arch))]
        if picks is None:
            ig = rdraws.gumbel_pick(a["log_alphas"], g)
            ir = rdraws.partner(ig, 8, g)
        else:
            ig, ir = (t.to(dev) for t in picks[1])
        own.append((ig.cpu(), ir.cpu()))
        p, mom, l1 = rsteps.weight_step(
            rnet, p, a, mom, masks, um, half(xs[1]).to(f32), half(ys[1]),
            lr, ig, ir, hp=hp)
    moved = [x - y for x, y in zip(rsteps.leaves(p) + rsteps.leaves(a),
                                   rsteps.leaves(params)
                                   + rsteps.leaves(arch))]
    return {"pick_mismatch": mismatch, "picks": own,
            "n_weights": len(rsteps.leaves(params)),
            "losses": [float(l0), float(la), float(l1)],
            "grads": gw + ga, "moved": moved}


def readings(prog, ref):
    """The compared numbers of a program side (the program's set-up
    steps, or the reference put in its place) against the reference. Leaf
    groups: the weights, log_alphas (what the search learns; a group of
    its own, so that no median of the arch leaves can hide it) and the
    betas."""
    n = ref["n_weights"]
    out = {"pick_mismatch": prog.get("pick_mismatch", 0)}
    out.update(compare.training_readings(prog, ref, {
        "weights": slice(0, n), "log_alphas": slice(n, n + 1),
        "betas": slice(n + 1, None)}))
    return out


def detail(prog, ref, params, arch):
    """The leaves with the widest gaps, for looking into a reading."""
    names = compare.paths(params) + ["arch/" + p
                                     for p in compare.paths(arch)]
    return compare.top_leaves(prog, ref, names)


def control(run, mode):
    """The compared numbers of the reference put in the program's place,
    in `mode` ("float8": the control; "half_batch": a fault), against
    the reference, at the cell's sizes from the run's seed. mode
    "float64": the float32 reference in the program's place, against the
    reference in float64."""
    cfg, tr = run.config, run.traffic
    rnet, params, arch, mc, lut, (xs, ys), (xv, yv) = make_inputs(run, cfg,
                                                                   tr)
    hp = hparams(cfg)
    lr, T = epoch_lr_T(cfg, tr["epoch"])
    args = (run, rnet, params, arch, mc, lut, xs, ys, xv, yv)
    ref = reference_steps(*args, None, hp, lr, T,
                          mode="float64" if mode == "float64" else None)
    side = reference_steps(*args, ref["picks"], hp, lr, T,
                           mode=None if mode == "float64" else mode)
    run.detail = detail(side, ref, params, arch)
    run.leaf_gaps = leaf_gaps(side, ref)
    return readings(side, ref)


def leaf_gaps(prog, ref):
    """Every leaf's norm of the difference of the first gradient, for the
    look into which leaves read widest."""
    return [round(float(v), 5) for v in compare.norm_of_diff(
        prog["grads"], ref["grads"], [slice(None)])]
