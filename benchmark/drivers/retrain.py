"""The retrain cells: the eval network's training step
(`parallel/train_dp.make_eval_steps(...).train_step`, eager), fed as
`tfnas_tpu_torch.train_eval` feeds it.

input "jpeg": JPEGs made once per checkout (benchmark/jpegs.py) through
`ImageList(training=True)` -> `DataLoader` -> `DevicePrefetcher` (on the
card: nvJPEG decode and the augment kernel), normalised on the card.
input "synth": device-resident batches made from --seed, cycled; no
loader.

Set-up makes the weights and the loader (or batches) from --seed and runs
the driver's loop body (next batch, the drop-connect and dropout draws,
`train_step`) for the three steps the check holds against the plain
reference; the window runs the same loop for --seconds. The check
compares the decoded and augmented pixels of those three batches (jpeg),
the first step's change of the BN running statistics (what the forward
made) and the three steps' first gradient and change.

Traffic parameters: batch_size, input, jpegs (the set's
spec, see jpegs.py), workers (the loader's threads), epoch (the loader's
and the lr schedule's), synth_batches, trace_steps.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import math
import time

import numpy as np
import torch

from .. import compare, jpegs
from ..flops import evalnet_macs
from ..harness import BENCH
from ..reference import augment, lowp
from ..reference import steps as rsteps
from ..reference.evalnet import EvalNet
from ..reference.nn import Pool, strict_float32
from .common import (EventTimer, Throttle, clone_tree, free_cuda, profiled,
                     sync, trace_summary)


def hparams(cfg):
    return {k: cfg[k] for k in ("momentum", "weight_decay", "grad_clip",
                                "label_smooth")}


def epoch_lr(cfg, epoch):
    """Per-epoch cosine lr with the 5-epoch linear warm-up of a global
    batch above 256 (the port's cosine_lr_with_warmup)."""
    lr = cfg["lr"] * (1 + math.cos(math.pi * epoch / cfg["epochs"])) / 2
    if epoch < cfg["warmup_epochs"] and cfg["global_batch"] > 256:
        lr = lr * (epoch + 1) / cfg["warmup_epochs"]
    return lr


def jpeg_set(tr):
    """(root, list path) of the traffic's JPEG set, made when missing."""
    spec = tr["jpegs"]
    tag = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         ).hexdigest()[:12]
    root = BENCH / ".data" / f"jpegs_{tag}"
    return root, jpegs.make_set(str(root), spec)


def ref_net(cfg):
    return EvalNet(cfg["model_config"], cfg["num_classes"],
                   cfg["dropout_rate"], cfg["drop_connect_rate"])


def synth_batches(run, cfg, tr):
    """Batches of random uint8 pixels."""
    g = run.generator(2)
    n, s = tr["batch_size"], cfg["image_size"]
    x = torch.randint(0, 256, (tr["synth_batches"], n, s, s, 3),
                      generator=g, device=run.device, dtype=torch.uint8)
    y = torch.randint(0, cfg["num_classes"], (tr["synth_batches"], n),
                      generator=g, device=run.device)
    return x, y


def loader_seed(run):
    return run.np_seed(6) % (2 ** 31)


def image_list(run, cfg, tr):
    from tfnas_tpu_torch.data import ImageList
    root, lst = jpeg_set(tr)
    return ImageList(str(root), lst, training=True,
                     image_size=cfg["image_size"],
                     rrc_scale=(cfg["rrc_min_scale"], 1.0), device=run.device)


def program_batches(run, cfg, tr):
    """An endless iterator of the driver's device batches."""
    from tfnas_tpu_torch.data import DataLoader, DevicePrefetcher
    if tr["input"] == "synth":
        x, y = synth_batches(run, cfg, tr)
        k = x.shape[0]
        return ((x[i % k], y[i % k]) for i in itertools.count())
    dl = DataLoader(image_list(run, cfg, tr), tr["batch_size"], shuffle=True,
                    num_workers=tr["workers"], seed=loader_seed(run))

    def epochs():
        for ep in itertools.count(tr["epoch"]):
            dl.set_epoch(ep)
            yield from DevicePrefetcher(iter(dl), run.device)
    return epochs()


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
    batches = program_batches(run, cfg, tr)
    gen = run.generator(3)
    prep = device_normalizer(dtype)
    timer = EventTimer(dev)
    waits = rec.host_ms.setdefault("loader_wait", [])
    step_fn = timer.wrap("train_step", train_step) if run.trace \
        else train_step

    def step(state, timed_wait=False):
        t0 = time.perf_counter()
        x, y = next(batches)
        if timed_wait:
            waits.append((time.perf_counter() - t0) * 1e3)
        keep = net.draw_keep(len(y), gen)
        state, m = step_fn(state, prep(x), y, lr, keep)
        return state, m, x

    # -- set-up: the three steps the check follows ----------------------
    pixels, losses = [], []
    for k in range(3):
        state, m, x = step(state)
        pixels.append(x.clone())
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
    prog_losses = [float(l) for l in losses]
    sync(dev)

    # -- the window ---------------------------------------------------------
    throttle = Throttle(dev)
    timer.pairs.clear()
    t_start = time.perf_counter()
    rec.setup_s = t_start - run.t0
    t_end, n = t_start + run.seconds, 0
    while time.perf_counter() < t_end:
        throttle.step()
        state, m, _ = step(state, timed_wait=run.trace)
        n += 1
    sync(dev)
    rec.window_s = time.perf_counter() - t_start
    rec.counts.update(steps=n, attempted=n, images=n * tr["batch_size"])
    rec.flops = 3.0 * 2.0 * evalnet_macs(rnet, cfg["image_size"]) * \
        rec.counts["images"]
    rec.cuda_ms.update(timer.ms())
    if run.trace:
        out = {}
        k = tr["trace_steps"]
        with profiled(dev, out):
            for _ in range(k):
                state, m, _ = step(state)
        rec.trace = trace_summary(out["trace"])
        rec.trace.update(obj=out["trace"], steps=k)
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)

    # -- the check ----------------------------------------------------------
    del state, batches, net, train_step, step_fn
    free_cuda(dev)
    own = reference_batches(run, cfg, tr)
    if tr["input"] == "jpeg":
        # nvJPEG's IDCT and upsampling round otherwise than PIL's, so the
        # steps follow the program's decoded pixels (with the reference's
        # labels); pixel_gap holds the decode and augment by themselves
        steps_on = [(p, y) for p, (_, y) in zip(pixels, own)]
    else:
        steps_on = own
    ref = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                          batches=steps_on)
    prog = {"losses": prog_losses, "grads": grads, "moved": moved,
            "bn_moved": bn_moved}
    run.readings = readings(prog, ref)
    run.detail = compare.top_leaves(prog, ref, compare.paths(params))
    if tr["input"] == "jpeg":
        per = torch.stack([(p.float() - r.float()).abs().mean(dim=(1, 2, 3))
                           for p, (r, _) in zip(pixels, own)])  # [3, n]
        run.readings["pixel_gap"] = float(per.max())
        k, i = divmod(int(per.argmax()), per.shape[1])
        rows = (pixels[k][i].float() - own[k][0][i].float()).abs().mean(
            dim=(1, 2))
        run.detail = {"leaves": run.detail, "worst_image": [k, i],
                      "rows_over_3": int((rows > 3).sum()),
                      "row_gaps": [round(float(v), 2) for v in rows[::8]]}
        if run.readings["pixel_gap"] > tr["limits"]["pixel_gap"]:
            run.detail["decoded_again"] = decode_again(run, cfg, tr, k, i,
                                                       own[k][0][i])
    for name in run.traffic["limits"]:  # a number not read fails
        run.check(name, run.readings.get(name, float("nan")))


def decode_again(run, cfg, tr, bi, i, ref_pixels):
    """A second witness for a pixel gap over its limit: batch bi's image i
    decoded and augmented again by the program alone (one thread, the
    same bytes and draws), its mean gap from the reference's pixels and
    its entry in the list."""
    ds = image_list(run, cfg, tr)
    order = augment.epoch_order(len(ds), loader_seed(run), tr["epoch"])
    n = tr["batch_size"]
    indices = [int(j) for j in order[bi * n:(bi + 1) * n]]
    xs, _ = ds.get_batch(indices, np.random.default_rng(
        (loader_seed(run), tr["epoch"], bi)))
    sync(run.device)
    x = torch.as_tensor(xs[i]).to(ref_pixels.device)
    gap = (x.float() - ref_pixels.float()).abs().mean()
    return {"entry": ds.img_list[indices[i]][0], "gap": float(gap)}


def readings(prog, ref):
    """The compared numbers of a program side against the reference: the
    training numbers over the weights, and bn_diff, the median BN leaf's
    norm of the difference of the first step's change of the running
    statistics (against the larger of its own and the median leaf's)."""
    out = compare.training_readings(prog, ref, {"weights": slice(None)})
    out["bn_diff"] = float(compare.norm_of_diff(
        prog["bn_moved"], ref["bn_moved"], [slice(None)]).median())
    return out


def reference_batches(run, cfg, tr):
    """The three checked batches as the reference makes them: the same
    bytes under the same draws through PIL and the plain augment (jpeg),
    or the same device batches (synth); uint8 and labels."""
    if tr["input"] == "synth":
        x, y = synth_batches(run, cfg, tr)
        k = x.shape[0]
        return [(x[i % k], y[i % k]) for i in range(3)]
    root, lst = jpeg_set(tr)
    with open(lst) as f:
        entries = [(l.split()[0], int(l.split()[1])) for l in f if l.strip()]
    seed, n = loader_seed(run), tr["batch_size"]
    order = augment.epoch_order(len(entries), seed, tr["epoch"])
    return [augment.train_batch(
        str(root), entries, order[bi * n:(bi + 1) * n], seed, tr["epoch"],
        bi, cfg["image_size"], (cfg["rrc_min_scale"], 1.0), run.device)
        for bi in range(3)]


def reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                    mode=None, batches=None):
    """The three checked steps through the plain reference in float32
    (TF32 off), with the program's drop-connect and dropout draws; mode
    "float8": the control; "half_batch": a fault, each step on its first
    half."""
    strict_float32()
    batches = batches or reference_batches(run, cfg, tr)
    gen = run.generator(3)
    p, s = clone_tree(params), clone_tree(bn_state)
    mom = rsteps.tree_map(torch.zeros_like, p)
    losses = []
    ctx = lowp.float8() if mode == "float8" else contextlib.nullcontext()
    with ctx:
        for k, (x, y) in enumerate(batches):
            keep = rnet.draw_keep(x.shape[0], gen)
            xf = augment.normalize(x)
            if mode == "half_batch":
                h = x.shape[0] // 2
                xf, y = xf[:h], y[:h]
                keep = [None if t is None else t[:h] for t in keep]
            p, s, mom, loss = rsteps.retrain_step(rnet, p, s, mom, xf, y, lr,
                                                  keep, hp=hp)
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
    in `mode`, against the reference, at the cell's sizes."""
    cfg, tr = run.config, run.traffic
    hp = hparams(cfg)
    lr = epoch_lr(cfg, tr["epoch"])
    rnet = ref_net(cfg)
    params, bn_state = rnet.init(Pool(run.generator(1)))
    batches = reference_batches(run, cfg, tr)
    ref = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                          batches=batches)
    side = reference_steps(run, rnet, params, bn_state, cfg, tr, hp, lr,
                           mode=mode, batches=batches)
    return readings(side, ref)
