"""Retrain a searched TF-NAS architecture on PyTorch (counterpart of the
repository's train_eval.py).

    python -m tfnas_tpu_torch.train_eval --config_path model.config \
        --train_root ... --train_list ... --val_root ... --val_list ... \
        --save /tmp/eval

    torchrun --nproc_per_node N -m tfnas_tpu_torch.train_eval ...

The JAX driver's flags and defaults (`--device`, default cuda): bf16
activations unless --no_bf16, SGD momentum with label smoothing, per-epoch
cosine lr, drop-connect and dropout drawn from a torch.Generator seeded by
--seed. Under torchrun each process takes the card of its LOCAL_RANK and
--batch_size is the global batch: every rank takes batch / world of it
(real lists through ImageList's host shard, --synthetic as rows of the
global batch), BN is cross-replica and the gradients are averaged (one
NCCL all-reduce per step; gloo with --device cpu). Rank r > 0 draws its
drop-connect and dropout from its own generator. Only rank 0 logs to a
file and writes. Real lists go through ImageList (uint8 pixels), the
threaded DataLoader and the card's prefetcher, and are normalised on the
card; --synthetic makes the JAX driver's numpy batches. Validation is
exact over the padded full set, across the ranks. Every epoch writes
checkpoint.pkl (and model_best.pkl on a new best top-1) under the run
directory, with the JAX driver's keys and parameter layout, so the JAX
package's test.py reads it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import time

import torch

from .convert import eval_state_from_jax, params_to_jax
from .data import (DataLoader, DevicePrefetcher, ImageList, device_normalizer,
                   image_decoder, synthetic_loader)
from .device import resolve_device
from .models.eval_net import EvalNetwork
from .parallel.mesh import (host_shard, is_main_process, local_device,
                            make_mesh, maybe_distributed_init, pair_seed)
from .parallel.train_dp import (cosine_lr_with_warmup, init_eval_train_state,
                                make_eval_steps)
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)
from .utils import (load_checkpoint, save_checkpoint, setup_experiment,
                    setup_rank_logging, trace)

parser = argparse.ArgumentParser(
    "training the searched architecture on imagenet (PyTorch)")
parser.add_argument('--train_root', type=str, default='')
parser.add_argument('--val_root', type=str, default='')
parser.add_argument('--train_list', type=str, default='')
parser.add_argument('--val_list', type=str, default='')
parser.add_argument('--model_path', type=str, default='',
                    help='the searched model path')
parser.add_argument('--config_path', type=str, default='',
                    help='the model config path')
parser.add_argument('--save', type=str, default='./checkpoints/')
parser.add_argument('--snapshot', type=str, default='', help='for reset')
parser.add_argument('--print_freq', type=int, default=100)
parser.add_argument('--workers', type=int, default=16)
parser.add_argument('--epochs', type=int, default=250)
parser.add_argument('--batch_size', type=int, default=512)
parser.add_argument('--lr', type=float, default=0.2)
parser.add_argument('--momentum', type=float, default=0.9)
parser.add_argument('--weight_decay', type=float, default=1e-5)
parser.add_argument('--grad_clip', type=float, default=5.0)
parser.add_argument('--label_smooth', type=float, default=0.1)
parser.add_argument('--num_classes', type=int, default=1000)
parser.add_argument('--dropout_rate', type=float, default=0.2)
parser.add_argument('--drop_connect_rate', type=float, default=0.2)
parser.add_argument('--seed', type=int, default=2)
parser.add_argument('--note', type=str, default='try')
parser.add_argument('--bf16', action='store_true', default=True)
parser.add_argument('--no_bf16', dest='bf16', action='store_false')
parser.add_argument('--synthetic', action='store_true')
parser.add_argument('--steps_per_epoch', type=int, default=0)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--rrc_min_scale', type=float, default=0.08,
                    help='RandomResizedCrop min area fraction')
parser.add_argument('--device', type=str, default='cuda')


def build_model(args):
    """The architecture from --model_path (a searched checkpoint of the
    reference space) or --config_path (a model.config JSON)."""
    if args.model_path and os.path.isfile(args.model_path):
        op_weights, depth_weights = get_op_and_depth_weights(args.model_path)
        parsed_arch = parse_architecture(op_weights, depth_weights)
        mc_mask_dddict = load_checkpoint(args.model_path)['mc_mask_dddict']
        return EvalNetwork.from_parsed_arch(
            args.num_classes, parsed_arch, get_mc_num_dddict(mc_mask_dddict),
            args.dropout_rate, args.drop_connect_rate)
    if args.config_path and os.path.isfile(args.config_path):
        with open(args.config_path) as f:
            model_config = json.load(f)
        return EvalNetwork.from_config(args.num_classes, model_config,
                                       args.dropout_rate,
                                       args.drop_connect_rate)
    raise SystemExit('invalid --model_path and --config_path')


def local_batch(batch_size):
    """This rank's share of the global batch."""
    shard = host_shard()
    if shard is None:
        return batch_size
    if batch_size % shard[1]:
        raise SystemExit(f"--batch_size {batch_size} does not divide over "
                         f"{shard[1]} ranks")
    return batch_size // shard[1]


def make_loaders(args, device=None):
    """(train_iter(epoch), val_iter(epoch)) of batches, this rank's share
    of each global batch; validation batches are (x, y, n_valid) over the
    padded full set. Real lists decode for `device` (on the card for a
    CUDA device)."""
    bs = local_batch(args.batch_size)
    if args.synthetic:
        spe = args.steps_per_epoch or 50

        def train_iter(ep):
            return synthetic_loader(args.batch_size, spe, args.num_classes,
                                    args.image_size, seed=(ep, 0),
                                    shard=host_shard())

        def val_iter(ep):
            return synthetic_loader(args.batch_size, max(spe // 4, 1),
                                    args.num_classes, args.image_size,
                                    seed=(99_000 + ep, 0),
                                    shard=host_shard())
        return train_iter, val_iter
    train_ds = ImageList(args.train_root, args.train_list, training=True,
                         image_size=args.image_size, host_shard=host_shard(),
                         rrc_scale=(args.rrc_min_scale, 1.0), device=device)
    val_ds = ImageList(args.val_root, args.val_list, training=False,
                       image_size=args.image_size, host_shard=host_shard(),
                       device=device)
    tl = DataLoader(train_ds, bs, shuffle=True,
                    num_workers=args.workers, seed=args.seed)
    vl = DataLoader(val_ds, bs, shuffle=False,
                    num_workers=args.workers, seed=args.seed,
                    drop_last=False, pad_last=True)

    def train_iter(ep):
        tl.set_epoch(ep)
        it = iter(tl)
        if args.steps_per_epoch:
            return itertools.islice(it, args.steps_per_epoch)
        return it

    return train_iter, lambda ep: iter(vl)


def validate(val_step, state, batches, prep, device):
    """(loss, top1, top5) over every valid sample of `batches` (of every
    rank's), from sums kept on the device and pulled once, as numpy
    float32 values."""
    vacc = torch.zeros(4, device=device)
    for batch in DevicePrefetcher(batches, device):
        x, y = batch[0], batch[1]
        n_valid = batch[2] if len(batch) > 2 else len(y)
        wmask = torch.zeros(len(y), device=device)
        wmask[:n_valid] = 1.0
        m = val_step(state, prep(x), y, wmask)
        vacc += torch.stack([m["loss"], m["top1"], m["top5"],
                             torch.ones((), device=device)]) * m["count"]
    return _avg3(vacc)


def _avg3(acc):
    a = acc.cpu().numpy()  # the one pull
    n = max(a[3], 1.0)
    return a[0] / n, a[1] / n, a[2] / n


def main(argv=None):
    args = parser.parse_args(argv)
    device = local_device(resolve_device(args.device))
    rank, world = maybe_distributed_init(device)
    net = build_model(args)
    train_iter, val_iter = make_loaders(args, device)
    run_dir = None
    if is_main_process():
        run_dir = setup_experiment(args.save, 'eval', args.note)
        with open(os.path.join(run_dir, 'model.config'), 'w') as f:
            json.dump(net.config, f, indent=4)
    else:
        setup_rank_logging(rank)
    logging.info("args = %s", args)
    logging.info("device: %s, rank %d of %d", device, rank, world)
    if not args.synthetic:
        logging.info("image decode: %s", image_decoder(device))

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    train_step, val_step = make_eval_steps(
        net, num_classes=args.num_classes, label_smooth=args.label_smooth,
        momentum=args.momentum, weight_decay=args.weight_decay,
        grad_clip=args.grad_clip, compute_dtype=dtype,
        group=make_mesh(world).data_group)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_eval_train_state(net, gen)  # the same on every rank
    if rank:
        gen.manual_seed(pair_seed(args.seed, rank))

    start_epoch, best_acc_top1, best_acc_top5 = 0, 0.0, 0.0
    if args.snapshot:
        logging.info('loading snapshot from %s', args.snapshot)
        ckpt = load_checkpoint(args.snapshot)
        state = eval_state_from_jax(ckpt, device)
        start_epoch = ckpt['epoch']
        best_acc_top1 = ckpt['best_acc_top1']
        best_acc_top5 = ckpt['best_acc_top5']

    # uint8 batches are normalised on the card; float batches only cast
    prep = device_normalizer(dtype)
    for epoch in range(start_epoch, args.epochs):
        trace.reset()  # traced runs keep one epoch of spans in memory
        lr = cosine_lr_with_warmup(args.lr, args.epochs, epoch,
                                   args.batch_size)
        logging.info('Epoch: %d lr %e', epoch, lr)
        # [loss * n, top1 * n, top5 * n, n] on the device; one pull per log
        macc = torch.zeros(4, device=device)
        epoch_start = time.time()
        for step, (x, y) in enumerate(
                DevicePrefetcher(train_iter(epoch), device)):
            keep = net.draw_keep(len(y), gen)
            state, m = train_step(state, prep(x), y, lr, keep)
            macc += torch.stack([m["loss"], m["top1"], m["top5"],
                                 torch.ones((), device=device)]) * len(y)
            if step % args.print_freq == 0:
                loss_a, top1_a, top5_a = _avg3(macc)
                logging.info('TRAIN Step: %03d Objs: %e R1: %f R5: %f',
                             step, loss_a, top1_a, top5_a)
        logging.info('Train_acc: %f', _avg3(macc)[1])

        _, val_acc_top1, val_acc_top5 = validate(
            val_step, state, val_iter(epoch), prep, device)
        logging.info('Val_acc_top1: %f', val_acc_top1)
        logging.info('Val_acc_top5: %f', val_acc_top5)
        logging.info('Epoch time: %ds.', time.time() - epoch_start)

        is_best = val_acc_top1 > best_acc_top1
        if is_best:
            best_acc_top1, best_acc_top5 = val_acc_top1, val_acc_top5
        if run_dir is None:
            continue
        save_checkpoint({
            'epoch': epoch + 1,
            'params': params_to_jax(state.params),
            'bn_state': params_to_jax(state.bn_state),
            'momentum': params_to_jax(state.momentum),
            'best_acc_top1': best_acc_top1,
            'best_acc_top5': best_acc_top5,
            'model_config': net.config,
        }, is_best, run_dir)
    return run_dir


if __name__ == '__main__':
    main()
