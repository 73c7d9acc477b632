"""TF-NAS supernet search driver on PyTorch
(counterpart of the repository's train_search.py).

    python -m tfnas_tpu_torch.train_search --synthetic --save /tmp/search ...

Same flags and defaults as the JAX driver for `--space mbconv`, `--space
hybrid` (the 9-op conv/ViT space: its LUT must hold the ViT keys, as
`make_lat_lut --space hybrid` writes them) and `--space tiny`, plus
`--device` (default cuda). Real lists (--img_root,
--train_list, --val_list) go through ImageList (uint8 pixels), the threaded
DataLoader and the card's prefetcher and are normalised on the card;
--synthetic makes the JAX driver's numpy batches.
Warmup epochs take one Gumbel-sampled weight step per batch; later epochs
take a bi-sampling weight step per batch and a soft arch step after every
second one, starting with the first (the JAX driver's order), then rescale
the widths against the latency table. --profile_steps N traces the first N
steps of the first epoch with torch.profiler into <run_dir>/profile/ (not
when that epoch runs scanned units), the port's spans (utils/trace.py) on
for those steps; TFNAS_TRACE=1 turns the spans on for the whole run and
logs each step's batch fetch and dispatch ms. With --scan_units K > 1,
full groups of 2K batches run as K units of two weight steps followed by
one arch step (the JAX driver's scanned schedule) and the epoch's last
batches step by step in the first order. On the card every step is
replayed from a CUDA graph (search/compiled.py) unless --eager is given:
the driver keeps its state in the graphs' static buffers and, at each
epoch boundary, writes the new masks, latency vector, lr and T into them
and zeros the optimiser state in place. Each epoch writes
arch_params_NN.pkl and, every --save_freq epochs, searched_model_NN.pkl
(the full supernet, about 376 MB at full width) under --save: point
--save outside the repository.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import logging
import os
import pickle
import time

import numpy as np
import torch

from .convert import arch_from_jax, params_from_jax, params_to_jax
from .cost.lut import (build_space_analytic_lut, lat_vectors_for_mc,
                       load_lat_lookup)
from .data import (DataLoader, DevicePrefetcher, ImageList, device_normalizer,
                   image_decoder, synthetic_loader)
from .device import resolve_device
from .models import hybrid_space as hs
from .models import search_space as ss
from .models.supernet import SuperNetwork
from .models.supernet_hybrid import HybridSuperNetwork
from .search.bisample import (gumbel_uniform, sample_gumbel_indices,
                              sample_random_excluding)
from .search.elasticity import rewrite_masks_by_l1, shrink_or_expand
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)
from .search.compiled import GraphFamily, copy_tree_, leaves_of
from .search.train_step import (adam_init, cosine_lr_list, make_search_steps,
                                make_scanned_search_iter, tree_leaves,
                                zeros_like_tree)
from .utils import (load_checkpoint, save_checkpoint_file, setup_experiment,
                    to_numpy_tree, trace)

parser = argparse.ArgumentParser("searching TF-NAS (PyTorch)")
parser.add_argument('--img_root', type=str, default='')
parser.add_argument('--train_list', type=str,
                    default="./dataset/ImageNet-100-effb0_train_cls_ratio0.8.txt")
parser.add_argument('--val_list', type=str,
                    default="./dataset/ImageNet-100-effb0_val_cls_ratio0.8.txt")
parser.add_argument('--lookup_path', type=str,
                    default="./latency_pkl/latency_tpu.pkl")
parser.add_argument('--save', type=str, default='./checkpoints')
parser.add_argument('--print_freq', type=int, default=100)
parser.add_argument('--workers', type=int, default=4)
parser.add_argument('--epochs', type=int, default=90)
parser.add_argument('--warmup_epochs', type=int, default=10)
parser.add_argument('--batch_size', type=int, default=32)
parser.add_argument('--w_lr', type=float, default=0.025)
parser.add_argument('--w_mom', type=float, default=0.9)
parser.add_argument('--w_wd', type=float, default=1e-5)
parser.add_argument('--a_lr', type=float, default=0.01)
parser.add_argument('--a_wd', type=float, default=5e-4)
parser.add_argument('--a_beta1', type=float, default=0.5)
parser.add_argument('--a_beta2', type=float, default=0.999)
parser.add_argument('--grad_clip', type=float, default=5.0)
parser.add_argument('--T', type=float, default=5.0)
parser.add_argument('--T_decay', type=float, default=0.96)
parser.add_argument('--num_classes', type=int, default=100)
parser.add_argument('--seed', type=int, default=2)
parser.add_argument('--note', type=str, default='try')
parser.add_argument('--lambda_lat', type=float, default=0.1)
parser.add_argument('--target_lat', type=float, default=15.0)
parser.add_argument('--lat_under_boost', type=float, default=1.0)
parser.add_argument('--bf16', action='store_true', default=True)
parser.add_argument('--no_bf16', dest='bf16', action='store_false')
parser.add_argument('--space', type=str, default='mbconv',
                    choices=['mbconv', 'hybrid', 'tiny'])
parser.add_argument('--synthetic', action='store_true')
parser.add_argument('--resume', type=str, default='')
parser.add_argument('--save_freq', type=int, default=1)
parser.add_argument('--steps_per_epoch', type=int, default=0)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--rrc_min_scale', type=float, default=0.08)
parser.add_argument('--scan_units', type=int, default=1,
                    help='K > 1: after the warmup epochs, run full groups '
                         'of 2K batches as K units of (2 weight steps + 1 '
                         'arch step) per call, as the JAX driver\'s scan '
                         'does')
parser.add_argument('--profile_steps', type=int, default=0,
                    help='trace the first N steps of the first epoch with '
                         'torch.profiler into <run_dir>/profile')
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--eager', action='store_true',
                    help='run the steps eagerly on the card instead of '
                         'replaying them from CUDA graphs')


def load_resume(path, device):
    """(params, arch_params, mc_mask_dddict, epoch, T) of a search
    checkpoint written by either package's driver."""
    ckpt = load_checkpoint(path)
    return (params_from_jax(ckpt['params'], device),
            arch_from_jax(ckpt['arch_params'], device),
            ckpt['mc_mask_dddict'], int(ckpt['epoch']), float(ckpt['T']))


def make_loaders(args, device=None):
    """(train_iter, val_iter, full_val_iter), each epoch -> batches: train
    batches, the arch steps' batches (shuffled, whole batches) and the
    final validation's (x, y, n_valid) over the padded full set. Real
    lists decode for `device` (on the card for a CUDA device)."""
    if args.synthetic:
        spe = args.steps_per_epoch or 100

        def val(ep):
            return synthetic_loader(args.batch_size, max(spe // 4, 1),
                                    args.num_classes, args.image_size,
                                    seed=10_000 + ep)
        return (lambda ep: synthetic_loader(
                    args.batch_size, spe, args.num_classes, args.image_size,
                    seed=ep),
                val, val)
    train_ds = ImageList(args.img_root, args.train_list, training=True,
                         image_size=args.image_size,
                         rrc_scale=(args.rrc_min_scale, 1.0), device=device)
    val_ds = ImageList(args.img_root, args.val_list, training=False,
                       image_size=args.image_size, device=device)
    tl = DataLoader(train_ds, args.batch_size, shuffle=True,
                    num_workers=args.workers, seed=args.seed)
    vl = DataLoader(val_ds, args.batch_size, shuffle=True,
                    num_workers=args.workers, seed=args.seed + 1)
    fvl = DataLoader(val_ds, args.batch_size, shuffle=False,
                     num_workers=args.workers, seed=args.seed + 1,
                     drop_last=False, pad_last=True)

    def train_iter(ep):
        tl.set_epoch(ep)
        it = iter(tl)
        if args.steps_per_epoch:
            return itertools.islice(it, args.steps_per_epoch)
        return it

    def val_iter(ep):
        vl.set_epoch(ep)
        return iter(vl)

    return train_iter, val_iter, lambda ep: iter(fvl)


class GeneratorDraws:
    """The driver's draws, from one torch.Generator: a weight step's gumbel
    pick and its partner, an arch step's Gumbel uniform. valid: the [18,
    NUM_OPS] validity mask of the hybrid space (None: every slot)."""

    def __init__(self, generator, valid=None):
        self.generator, self.valid = generator, valid

    def gumbel(self, log_alphas):
        return sample_gumbel_indices(log_alphas, self.generator, self.valid)

    def partner(self, idx_g, num_ops):
        return sample_random_excluding(idx_g, num_ops, self.generator,
                                       self.valid)

    def uniform(self, shape):
        return gumbel_uniform(shape, self.generator)

    def units(self, k):
        """What make_scanned_search_iter draws from for k units: the
        generator itself, so the draws are made inside the units."""
        return self.generator


class Search:
    """The search loop's state and its epochs. On the card with a
    GraphFamily, every tree the steps read lives in the family's static
    buffers, written in place between replays.

    scan_units: None for the JAX driver's per-step order (an arch step
    after weight steps 0, 2, 4, ... of an epoch); K to run full groups of
    2K batches as K units of (2 weight steps + 1 arch step) through
    make_scanned_search_iter, the rest of the epoch in the per-step
    order."""

    def __init__(self, net, space, lat_lookup, params, arch_params,
                 mc_mask_dddict, device, *, step_kwargs, family=None,
                 scan_units=None):
        self.net, self.space, self.lut = net, space, lat_lookup
        self.device = device
        self.adopt = family.adopt if family is not None else (lambda t: t)
        self.steps = make_search_steps(net, capture=family is not None,
                                       family=family, **step_kwargs)
        self.scan = make_scanned_search_iter(net, arch_every=2,
                                             steps=self.steps,
                                             **step_kwargs)
        self.scan_units = scan_units
        self.params = self.adopt(params)
        self.arch_params = self.adopt(arch_params)
        self.mc_mask_dddict = mc_mask_dddict
        self.key_dddict = space.build_lat_lookup_key_dddict()
        self.masks = self.update_masks = self.lat_vec = None
        self.mom = self.opt_a = None
        self.lr = self.adopt(torch.zeros((), device=device))
        self.T = self.adopt(torch.zeros((), device=device))
        self.base_lat = self.adopt(torch.tensor(float(lat_lookup["base"]),
                                                device=device))
        self.num_ops = space.NUM_OPS

    def _set(self, name, value):
        """Rebind on the first epoch; later, write into the same buffers."""
        if getattr(self, name) is None:
            setattr(self, name, self.adopt(value))
        else:
            copy_tree_(getattr(self, name), value)

    def begin_epoch(self, lr, T):
        """Masks, update masks and latency vector of the current widths;
        fresh optimiser state (the reference recreates its optimisers every
        epoch); the epoch's lr and T."""
        mc_num_dddict = get_mc_num_dddict(self.mc_mask_dddict)
        self._set("masks", self.net.device_masks(self.mc_mask_dddict,
                                                 self.device))
        self._set("update_masks", self.net.update_masks(
            self.params, self.mc_mask_dddict))
        self._set("lat_vec", torch.from_numpy(lat_vectors_for_mc(
            self.lut, mc_num_dddict, self.key_dddict,
            self.num_ops)).to(self.device))
        if self.mom is None:
            self.mom = self.adopt(zeros_like_tree(self.params))
            self.opt_a = self.adopt(adam_init(self.arch_params))
        else:
            torch._foreach_zero_(leaves_of(self.mom) + leaves_of(self.opt_a))
        self.lr.fill_(lr)
        self.T.fill_(T)

    # -- steps --------------------------------------------------------------

    def warmup_step(self, x, y, draws):
        idx_g = draws.gumbel(self.arch_params["log_alphas"])
        self.params, self.mom, m = self.steps.warmup_step(
            self.params, self.arch_params, self.mom, self.masks,
            self.update_masks, x, y, self.lr, idx_g)
        return m

    def weight_step(self, x, y, draws):
        idx_g = draws.gumbel(self.arch_params["log_alphas"])
        idx_r = draws.partner(idx_g, self.num_ops)
        self.params, self.mom, m = self.steps.weight_step(
            self.params, self.arch_params, self.mom, self.masks,
            self.update_masks, x, y, self.lr, idx_g, idx_r)
        return m

    def arch_step(self, xa, ya, draws):
        u = draws.uniform(self.arch_params["log_alphas"].shape)
        self.arch_params, self.opt_a, m = self.steps.arch_step(
            self.params, self.arch_params, self.opt_a, self.masks, xa, ya,
            self.lat_vec, self.base_lat, self.T, u)
        return m

    def units(self, xw, yw, xa, ya, draws):
        """K units through the scanned iteration; xw [K, 2, N, ...]."""
        (self.params, self.mom, self.arch_params, self.opt_a, wm,
         am) = self.scan(self.params, self.mom, self.arch_params, self.opt_a,
                         self.masks, self.update_masks, xw, yw, xa, ya,
                         self.lr, self.T, self.lat_vec, self.base_lat,
                         draws.units(xw.shape[0]))
        return wm, am

    # -- one epoch ----------------------------------------------------------

    def train_epoch(self, batches, arch_batches, draws, warm, prep, log=None,
                    print_freq=100):
        """One epoch over `batches` (device (x, y) pairs); arch_batches()
        yields the arch steps' batches, restarted when it runs out. Returns
        the [7] metric sums [loss, top1, top5, loss_a, loss_l, weight
        steps, arch steps], on the device."""
        macc = torch.zeros(7, device=self.device)
        zero = torch.zeros((), device=self.device)
        one = torch.ones((), device=self.device)

        def acc_w(m):
            macc.add_(torch.stack([m["loss"], m["top1"], m["top5"], zero,
                                   zero, one, zero]))

        def acc_a(m):
            macc.add_(torch.stack([zero, zero, zero, m["loss_a"],
                                   m["loss_l"], zero, one]))

        def report(step):
            if log is not None:
                avg = _mavg(macc.tolist())
                log('TRAIN%s Step: %04d Objs: %f R1: %f R5: %f Objs_A: %f '
                    'Objs_L: %f', ' wo_Arch' if warm else ' w_Arch', step,
                    avg["loss"], avg["top1"], avg["top5"], avg["loss_a"],
                    avg["loss_l"])

        if warm:
            for step, (x, y) in enumerate(batches):
                acc_w(self.warmup_step(prep(x), y, draws))
                if step % print_freq == 0:
                    report(step)
            return macc

        arch_it = iter(arch_batches())

        def next_arch():
            nonlocal arch_it
            batch = next(arch_it, None)
            if batch is None:
                arch_it = iter(arch_batches())
                batch = next(arch_it)
            return batch

        def per_step(step, x, y):
            acc_w(self.weight_step(x, y, draws))
            if step % 2 == 0:
                xa, ya = next_arch()
                acc_a(self.arch_step(prep(xa), ya, draws))
            if step % print_freq == 0:
                report(step)

        if self.scan_units is None:
            for step, (x, y) in enumerate(batches):
                per_step(step, prep(x), y)
            return macc

        group = 2 * self.scan_units
        buf, step = [], 0
        for x, y in batches:
            buf.append((prep(x), y))
            if len(buf) < group:
                continue
            pairs = [next_arch() for _ in range(self.scan_units)]
            wm, am = self.units(
                torch.stack([b[0] for b in buf]).reshape(
                    self.scan_units, 2, *buf[0][0].shape),
                torch.stack([b[1] for b in buf]).reshape(
                    self.scan_units, 2, -1),
                torch.stack([prep(p[0]) for p in pairs]),
                torch.stack([p[1] for p in pairs]), draws)
            macc.add_(torch.stack([
                wm["loss"].sum(), wm["top1"].sum(), wm["top5"].sum(),
                am["loss_a"].sum(), am["loss_l"].sum(), one * group,
                one * self.scan_units]))
            if any((step + j) % print_freq == 0 for j in range(group)):
                report(step)
            step += group
            buf = []
        # the tail (fewer than 2K batches), step by step; `step` is even
        for j, (x, y) in enumerate(buf):
            per_step(step + j, x, y)
        return macc

    def end_epoch(self, target_lat, log=lambda *a: None):
        """Shrink or expand the widths toward target_lat and rewrite the
        masks by the L1 norm of the trained depthwise kernels."""
        self.mc_mask_dddict, _, _ = rescale_widths(
            self.arch_params, self.params, self.mc_mask_dddict, self.space,
            self.lut, target_lat, log)


def rescale_widths(arch_params, params, mc_mask_dddict, space, lat_lookup,
                   target_lat, log=lambda *a: None):
    """The epoch boundary of a search: parse the arch parameters, shrink or
    expand the parsed widths toward target_lat on the LUT, and rewrite the
    masks by the L1 norm of the trained depthwise kernels. Returns (new
    mc_mask_dddict, LUT latency before, after)."""
    op_weights, depth_weights = get_op_and_depth_weights(
        {"arch_params": to_numpy_tree(arch_params)})
    parsed_arch = parse_architecture(op_weights, depth_weights, space=space)
    mc_num_dddict, before_lat, after_lat = shrink_or_expand(
        parsed_arch, get_mc_num_dddict(mc_mask_dddict),
        get_mc_num_dddict(space.build_mc_mask_dddict(), is_max=True),
        space.build_lat_lookup_key_dddict(), lat_lookup, target_lat,
        log=log)
    log('Before, the current lat: %.4f, the target lat: %.4f',
        before_lat, target_lat)
    new_masks = rewrite_masks_by_l1(parsed_arch, mc_num_dddict,
                                    mc_mask_dddict, params)
    log('After, the current lat: %.4f, the target lat: %.4f', after_lat,
        target_lat)
    return new_masks, before_lat, after_lat


def profiled(batches, n, out_dir, device):
    """Yield `batches`; torch.profiler (CPU and, on the card, CUDA
    activities: CUPTI records the kernels of replayed CUDA graphs too)
    traces the steps run on the first n of them, with the port's spans on,
    so that their ranges lie beside the kernels. The Chrome trace is
    written into out_dir once the n-th step has run."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    it = iter(batches)
    was_on = trace.enabled()
    trace.enable()
    try:
        with profile(activities=acts) as prof:
            yield from itertools.islice(it, n)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        if not was_on:
            trace.disable()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logging.info('profiler trace written to %s', path)
    yield from it


def timed(batches):
    """Yield `batches`, logging per step the ms of its span
    `tfnas.search.fetch` (fetching its batch) and of `tfnas.search.step`
    (until the next fetch: the step's dispatch; on the card, the host's
    enqueueing, not the card's time)."""
    it = iter(batches)
    for step in itertools.count():
        with trace.clock("tfnas.search.fetch", step=step) as fetch:
            batch = next(it, None)
        if batch is None:
            return
        with trace.clock("tfnas.search.step", step=step) as run:
            yield batch
        logging.info("timing: fetch %.0fms dispatch %.0fms", fetch.ms,
                     run.ms)


def masks_to_numpy(mc_mask_dddict):
    """{stage: {block: {op: numpy mask}}}, as the checkpoints hold it."""
    return {st: {b: {o: np.asarray(m) for o, m in d.items()}
                 for b, d in sd.items()}
            for st, sd in mc_mask_dddict.items()}


def space_and_lut(args):
    """(space, lat_lookup) of --space: the tiny space gets its in-process
    analytic table, the others read --lookup_path. --space hybrid refuses
    a table without the ViT keys before anything is written."""
    if args.space == 'tiny':
        space = ss.tiny_space(args.image_size)
        return space, build_space_analytic_lut(space)
    space = hs if args.space == 'hybrid' else ss
    lat_lookup = load_lat_lookup(args.lookup_path)
    if args.space == 'hybrid':
        key_dddict = space.build_lat_lookup_key_dddict()
        missing = {key_dddict[st][b][hs.VIT_OP_IDX]
                   for st in key_dddict for b in key_dddict[st]
                   if hs.VIT_OP_IDX in key_dddict[st][b]} - set(lat_lookup)
        if missing:
            raise SystemExit(
                f"--space hybrid needs ViT entries in the LUT; missing "
                f"{sorted(missing)[:3]}... — regenerate with "
                f"python -m tfnas_tpu_torch.make_lat_lut --space hybrid")
    return space, lat_lookup


def _mavg(a):
    nw, na = max(a[5], 1.0), max(a[6], 1.0)
    return {"loss": a[0] / nw, "top1": a[1] / nw, "top5": a[2] / nw,
            "loss_a": a[3] / na, "loss_l": a[4] / na}


def main(argv=None):
    args = parser.parse_args(argv)
    if args.scan_units < 1:
        raise SystemExit("--scan_units must be at least 1")
    device = resolve_device(args.device)
    hybrid = args.space == 'hybrid'
    space, lat_lookup = space_and_lut(args)
    mc_mask_dddict = space.build_mc_mask_dddict()
    key_dddict = space.build_lat_lookup_key_dddict()
    train_iter, val_iter, full_val_iter = make_loaders(args, device)
    run_dir = setup_experiment(args.save, 'search', args.note)
    logging.info("args = %s", args)
    logging.info("device: %s", device)
    if not args.synthetic:
        logging.info("image decode: %s", image_decoder(device))
    mc_maxnum_dddict = get_mc_num_dddict(mc_mask_dddict, is_max=True)
    lv = lat_vectors_for_mc(lat_lookup, mc_maxnum_dddict, key_dddict,
                            space.NUM_OPS)
    valid = hs.valid_op_mask() > 0 if hybrid else np.ones(lv.shape, bool)
    logging.info(
        "LUT '%s': base %.4f ms; full-depth max-width arch in [%.4f, %.4f] "
        "ms depending on ops; --target_lat %.4f",
        args.lookup_path if args.space != 'tiny' else 'analytic',
        lat_lookup["base"],
        lat_lookup["base"] + np.where(valid, lv, np.inf).min(1).sum(),
        lat_lookup["base"] + lv.max(1).sum(), args.target_lat)

    net = (HybridSuperNetwork(args.num_classes) if hybrid
           else SuperNetwork(args.num_classes, space=space))
    valid_mask = net.valid_mask(device) if hybrid else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, arch_params = net.init(gen)
    start_epoch, T = 0, args.T
    if args.resume:
        logging.info('resuming from %s', args.resume)
        params, arch_params, mc_mask_dddict, start_epoch, T = load_resume(
            args.resume, device)
    logging.info("param size = %fMB", sum(
        p.numel() for p in tree_leaves(params)) / 1e6)

    family = (GraphFamily(device)
              if device.type == "cuda" and not args.eager else None)
    logging.info("steps: %s", "CUDA graphs" if family else "eager")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    search = Search(
        net, space, lat_lookup, params, arch_params, mc_mask_dddict, device,
        step_kwargs=dict(
            num_classes=args.num_classes, w_mom=args.w_mom, w_wd=args.w_wd,
            a_lr=args.a_lr, a_beta1=args.a_beta1, a_beta2=args.a_beta2,
            a_wd=args.a_wd, grad_clip=args.grad_clip,
            lambda_lat=args.lambda_lat, target_lat=args.target_lat,
            lat_under_boost=args.lat_under_boost, valid_mask=valid_mask),
        family=family,
        scan_units=args.scan_units if args.scan_units > 1 else None)
    del params, arch_params
    draws = GeneratorDraws(gen, valid_mask)
    lr_list = cosine_lr_list(args.w_lr, args.epochs)

    def save_epoch(epoch, T, final=False):
        """arch_params_NN.pkl every epoch; searched_model_NN.pkl every
        --save_freq epochs and after the last, in the JAX package's
        format."""
        masks_np = masks_to_numpy(search.mc_mask_dddict)
        with open(f"{run_dir}/arch_params_{epoch:02d}.pkl", "wb") as f:
            pickle.dump({"arch_params": to_numpy_tree(search.arch_params),
                         "mc_mask_dddict": masks_np, "epoch": epoch,
                         "T": T}, f)
        if args.save_freq > 1 and not final and epoch % args.save_freq:
            return
        save_checkpoint_file(to_numpy_tree({
            "params": params_to_jax(search.params),
            "arch_params": search.arch_params,
            "mc_mask_dddict": copy.deepcopy(masks_np),
            "epoch": epoch,
            "T": T,
        }), f"{run_dir}/searched_model_{epoch:02d}.pkl")

    if not args.resume:
        save_epoch(0, T)

    # uint8 batches are normalised on the card; float batches only cast
    prep = device_normalizer(dtype)
    total_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        lr = lr_list[epoch]
        trace.reset()  # traced runs keep one epoch of spans in memory
        search.begin_epoch(lr, T)
        logging.info('Epoch: %d lr: %e T: %e', epoch, lr, T)
        epoch_start = time.time()
        warm = epoch < args.warmup_epochs
        batches = DevicePrefetcher(train_iter(epoch), device)
        stepwise = warm or args.scan_units == 1  # not scanned units
        if trace.enabled() and stepwise:
            batches = timed(batches)
        if args.profile_steps > 0 and epoch == start_epoch and stepwise:
            batches = profiled(batches, args.profile_steps,
                               f"{run_dir}/profile", device)
        macc = search.train_epoch(
            batches, lambda: DevicePrefetcher(val_iter(epoch), device), draws,
            warm, prep, log=logging.info, print_freq=args.print_freq)
        epoch_avg = _mavg(macc.tolist())
        if not warm:
            T *= args.T_decay

        logging.info('The current arch parameters are:')
        for row in np.exp(search.arch_params["log_alphas"].cpu().numpy()):
            logging.info(' '.join(f'{p:.6f}' for p in row))
        for stage in space.STAGE_NAMES:
            sm = torch.softmax(search.arch_params["betas"][stage],
                               0).cpu().numpy()
            logging.info(' '.join(f'{p:.6f}' for p in sm))
        logging.info('Train_acc %f', epoch_avg["top1"])
        logging.info('Epoch time: %ds', time.time() - epoch_start)

        if args.epochs - epoch < 5:
            # the padded full set, every sample scored once
            vacc = torch.zeros(3, device=device)
            for batch in DevicePrefetcher(full_val_iter(epoch), device):
                x, y = batch[0], batch[1]
                n_valid = batch[2] if len(batch) > 2 else len(y)
                wmask = torch.zeros(len(y), device=device)
                wmask[:n_valid] = 1.0
                idx_g = draws.gumbel(search.arch_params["log_alphas"])
                m = search.steps.val_step(search.params, search.arch_params,
                                          search.masks, prep(x), y, idx_g,
                                          wmask)
                vacc += torch.stack([m["top1"], m["top5"],
                                     torch.ones((), device=device)]) * n_valid
            va = vacc.tolist()
            logging.info('Val_acc %f', va[0] / max(va[2], 1.0))
            logging.info('Val_acc_top5 %f', va[1] / max(va[2], 1.0))

        if not warm:
            logging.info('Now shrinking or expanding the arch')
            search.end_epoch(args.target_lat, log=logging.info)

        save_epoch(epoch + 1, T, final=(epoch + 1 == args.epochs))

    if family is not None:
        for g in family.graphs:
            logging.info("graph %s: built in %.1fs, %d replays, fused "
                         "kernel nodes %s", g.name, g.build_s, g.replays,
                         g.nodes)
    logging.info('Total searching time: %ds', time.time() - total_start)
    return run_dir


if __name__ == '__main__':
    main()
