"""TF-NAS supernet search driver on PyTorch
(counterpart of the repository's train_search.py).

    python -m tfnas_tpu_torch.train_search --synthetic --save /tmp/search ...

Same flags and defaults as the JAX driver for `--space mbconv` and
`--space tiny`, plus `--device` (default cuda). Real lists (--img_root,
--train_list, --val_list) go through ImageList (uint8 pixels), the threaded
DataLoader and the card's prefetcher and are normalised on the card;
--synthetic makes the JAX driver's numpy batches.
The bi-level loop is a plain Python loop: warmup epochs take one
Gumbel-sampled weight step per batch; later epochs take a bi-sampling weight
step per batch and a soft arch step every second batch, then rescale the
widths against the latency table. Each epoch writes arch_params_NN.pkl and,
every --save_freq epochs, searched_model_NN.pkl (the full supernet, about
376 MB at full width) under --save: point --save outside the repository.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import logging
import pickle
import time

import numpy as np
import torch

from .convert import arch_from_jax, params_from_jax, params_to_jax
from .cost.lut import (build_space_analytic_lut, lat_vectors_for_mc,
                       load_lat_lookup)
from .data import (DataLoader, DevicePrefetcher, ImageList, device_normalizer,
                   synthetic_loader)
from .device import resolve_device
from .models import search_space as ss
from .models.supernet import SuperNetwork
from .search.bisample import (gumbel_uniform, sample_gumbel_indices,
                              sample_random_excluding)
from .search.elasticity import rewrite_masks_by_l1, shrink_or_expand
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)
from .search.train_step import (adam_init, cosine_lr_list, make_search_steps,
                                tree_leaves,
                                zeros_like_tree)
from .utils import (load_checkpoint, save_checkpoint_file, setup_experiment,
                    to_numpy_tree)

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
                    help='accepted for CLI compatibility; the port runs '
                         'the same schedule as a plain loop')
parser.add_argument('--device', type=str, default='cuda')


def load_resume(path, device):
    """(params, arch_params, mc_mask_dddict, epoch, T) of a search
    checkpoint written by either package's driver."""
    ckpt = load_checkpoint(path)
    return (params_from_jax(ckpt['params'], device),
            arch_from_jax(ckpt['arch_params'], device),
            ckpt['mc_mask_dddict'], int(ckpt['epoch']), float(ckpt['T']))


def make_loaders(args):
    """(train_iter, val_iter, full_val_iter), each epoch -> numpy batches:
    train batches, the arch steps' batches (shuffled, whole batches) and
    the final validation's (x, y, n_valid) over the padded full set."""
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
                         rrc_scale=(args.rrc_min_scale, 1.0))
    val_ds = ImageList(args.img_root, args.val_list, training=False,
                       image_size=args.image_size)
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


def main(argv=None):
    args = parser.parse_args(argv)
    if args.space == 'hybrid':
        raise SystemExit("--space hybrid is not yet ported to PyTorch")
    device = resolve_device(args.device)
    train_iter, val_iter, full_val_iter = make_loaders(args)
    run_dir = setup_experiment(args.save, 'search', args.note)
    logging.info("args = %s", args)
    logging.info("device: %s", device)

    if args.space == 'tiny':
        space = ss.tiny_space(args.image_size)
        lat_lookup = build_space_analytic_lut(space)
    else:
        space = ss
        lat_lookup = load_lat_lookup(args.lookup_path)
    mc_mask_dddict = space.build_mc_mask_dddict()
    key_dddict = space.build_lat_lookup_key_dddict()
    mc_maxnum_dddict = get_mc_num_dddict(mc_mask_dddict, is_max=True)
    lv = lat_vectors_for_mc(lat_lookup, mc_maxnum_dddict, key_dddict)
    logging.info(
        "LUT '%s': base %.4f ms; full-depth max-width arch in [%.4f, %.4f] "
        "ms depending on ops; --target_lat %.4f",
        args.lookup_path if args.space != 'tiny' else 'analytic',
        lat_lookup["base"], lat_lookup["base"] + lv.min(1).sum(),
        lat_lookup["base"] + lv.max(1).sum(), args.target_lat)

    net = SuperNetwork(args.num_classes, space=space)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, arch_params = net.init(gen)
    start_epoch, T = 0, args.T
    if args.resume:
        logging.info('resuming from %s', args.resume)
        params, arch_params, mc_mask_dddict, start_epoch, T = load_resume(
            args.resume, device)
    logging.info("param size = %fMB", sum(
        p.numel() for p in tree_leaves(params)) / 1e6)

    steps = make_search_steps(
        net, num_classes=args.num_classes, w_mom=args.w_mom, w_wd=args.w_wd,
        a_lr=args.a_lr, a_beta1=args.a_beta1, a_beta2=args.a_beta2,
        a_wd=args.a_wd, grad_clip=args.grad_clip,
        lambda_lat=args.lambda_lat, target_lat=args.target_lat,
        lat_under_boost=args.lat_under_boost)
    lr_list = cosine_lr_list(args.w_lr, args.epochs)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    num_ops = space.NUM_OPS

    def save_epoch(epoch, T, final=False):
        """arch_params_NN.pkl every epoch; searched_model_NN.pkl every
        --save_freq epochs and after the last, in the JAX package's
        format."""
        masks_np = {st: {b: {o: np.asarray(m) for o, m in d.items()}
                         for b, d in sd.items()}
                    for st, sd in mc_mask_dddict.items()}
        with open(f"{run_dir}/arch_params_{epoch:02d}.pkl", "wb") as f:
            pickle.dump({"arch_params": to_numpy_tree(arch_params),
                         "mc_mask_dddict": masks_np, "epoch": epoch,
                         "T": T}, f)
        if args.save_freq > 1 and not final and epoch % args.save_freq:
            return
        save_checkpoint_file(to_numpy_tree({
            "params": params_to_jax(params),
            "arch_params": arch_params,
            "mc_mask_dddict": copy.deepcopy(masks_np),
            "epoch": epoch,
            "T": T,
        }), f"{run_dir}/searched_model_{epoch:02d}.pkl")

    if not args.resume:
        save_epoch(0, T)

    # uint8 batches are normalised on the card; float batches only cast
    prep = device_normalizer(dtype)

    def val_batches(epoch):
        return iter(DevicePrefetcher(val_iter(epoch), device))

    total_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        mc_num_dddict = get_mc_num_dddict(mc_mask_dddict)
        masks = net.device_masks(mc_mask_dddict, device)
        update_masks = net.update_masks(params, mc_mask_dddict)
        lat_vec = torch.from_numpy(lat_vectors_for_mc(
            lat_lookup, mc_num_dddict, key_dddict, num_ops)).to(device)
        base_lat = float(lat_lookup["base"])
        # fresh optimizers every epoch, as the reference recreates them
        mom = zeros_like_tree(params)
        opt_a = adam_init(arch_params)
        lr = lr_list[epoch]
        logging.info('Epoch: %d lr: %e T: %e', epoch, lr, T)

        # [loss, top1, top5, loss_a, loss_l sums, weight steps, arch steps]
        # accumulate on the device; one pull per log line
        macc = torch.zeros(7, device=device)

        def mavg(a):
            nw, na = max(a[5], 1.0), max(a[6], 1.0)
            return {"loss": a[0] / nw, "top1": a[1] / nw, "top5": a[2] / nw,
                    "loss_a": a[3] / na, "loss_l": a[4] / na}

        epoch_start = time.time()
        warm = epoch < args.warmup_epochs
        arch_it = None if warm else val_batches(epoch)
        for step, (x, y) in enumerate(
                DevicePrefetcher(train_iter(epoch), device)):
            x = prep(x)
            log_alphas = arch_params["log_alphas"]
            idx_g = sample_gumbel_indices(log_alphas, gen)
            if warm:
                params, mom, m = steps.warmup_step(
                    params, arch_params, mom, masks, update_masks, x, y, lr,
                    idx_g)
            else:
                idx_r = sample_random_excluding(idx_g, num_ops, gen)
                params, mom, m = steps.weight_step(
                    params, arch_params, mom, masks, update_masks, x, y, lr,
                    idx_g, idx_r)
                if step % 2 == 0:
                    xa_ya = next(arch_it, None)
                    if xa_ya is None:
                        arch_it = val_batches(epoch)
                        xa_ya = next(arch_it)
                    arch_params, opt_a, ma = steps.arch_step(
                        params, arch_params, opt_a, masks, prep(xa_ya[0]),
                        xa_ya[1], lat_vec, base_lat, T,
                        gumbel_uniform(log_alphas.shape, gen))
                    macc[3] += ma["loss_a"]
                    macc[4] += ma["loss_l"]
                    macc[6] += 1
            macc[:3] += torch.stack([m["loss"], m["top1"], m["top5"]])
            macc[5] += 1
            if step % args.print_freq == 0:
                avg = mavg(macc.tolist())
                logging.info(
                    'TRAIN%s Step: %04d Objs: %f R1: %f R5: %f Objs_A: %f '
                    'Objs_L: %f', ' wo_Arch' if warm else ' w_Arch', step,
                    avg["loss"], avg["top1"], avg["top5"], avg["loss_a"],
                    avg["loss_l"])
        epoch_avg = mavg(macc.tolist())
        if not warm:
            T *= args.T_decay

        logging.info('The current arch parameters are:')
        for row in np.exp(arch_params["log_alphas"].cpu().numpy()):
            logging.info(' '.join(f'{p:.6f}' for p in row))
        for stage in space.STAGE_NAMES:
            sm = torch.softmax(arch_params["betas"][stage], 0).cpu().numpy()
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
                idx_g = sample_gumbel_indices(arch_params["log_alphas"], gen)
                m = steps.val_step(params, arch_params, masks, prep(x), y,
                                   idx_g, wmask)
                vacc += torch.stack([m["top1"], m["top5"],
                                     torch.ones((), device=device)]) * n_valid
            va = vacc.tolist()
            logging.info('Val_acc %f', va[0] / max(va[2], 1.0))
            logging.info('Val_acc_top5 %f', va[1] / max(va[2], 1.0))

        if not warm:
            logging.info('Now shrinking or expanding the arch')
            op_weights, depth_weights = get_op_and_depth_weights(
                {"arch_params": to_numpy_tree(arch_params)})
            parsed_arch = parse_architecture(op_weights, depth_weights,
                                             space=space)
            mc_num_dddict, before_lat, after_lat = shrink_or_expand(
                parsed_arch, get_mc_num_dddict(mc_mask_dddict),
                mc_maxnum_dddict, key_dddict, lat_lookup, args.target_lat,
                log=logging.info)
            logging.info('Before, the current lat: %.4f, the target lat: '
                         '%.4f', before_lat, args.target_lat)
            mc_mask_dddict = rewrite_masks_by_l1(
                parsed_arch, mc_num_dddict, mc_mask_dddict, params)
            logging.info('After, the current lat: %.4f, the target lat: '
                         '%.4f', after_lat, args.target_lat)

        save_epoch(epoch + 1, T, final=(epoch + 1 == args.epochs))

    logging.info('Total searching time: %ds', time.time() - total_start)
    return run_dir


if __name__ == '__main__':
    main()
