"""Multi-target-latency Pareto search on PyTorch (counterpart of the
repository's train_search_pareto.py): G independent TF-NAS searches, one
per --target_lats point, in one launch.

    torchrun --nproc_per_node N -m tfnas_tpu_torch.train_search_pareto \\
        --synthetic --target_lats 4.5,6.0 \\
        --lookup_path latency_pkl/latency_h100.pkl --save /tmp/pareto

The JAX driver's flags plus `--device` (default cuda) and `--eager`. The
groups are laid out over the ranks as parallel/mesh.py says: with N >= G
(N % G == 0) group g runs on N / G ranks, data-parallel with cross-replica
BN when that is more than one, and each rank takes --batch_size / (N / G)
of the group's batch; with N < G (G % N == 0) each rank runs G / N groups
one after another (one card can run every target). The schedule is the
JAX driver's: every batch a bi-sampling weight step (warmup epochs
included), and once `epoch >= --warmup_epochs` an arch step on the same
batch after every second one, starting with the first; T decays per group
after warmup. Each group then rescales its widths against its own target
and its first rank writes `searched_model_g{g}_NN.pkl` (the JAX driver's
keys: params, arch_params, mc_mask_dddict, epoch, T, target_lat) into rank
0's run directory. --resume takes one path per group, as a comma list or a
pattern with {g}. --synthetic: group g's batches are one stream seeded by
(epoch * 1000 + g, 0), the JAX driver's on one host, and each of the
group's ranks takes its rows of every batch, so a group sees the same
batches on any number of ranks. Real lists give group g the rows g::G of
one shuffled loader, sharded over the group's ranks; a rank decodes only
its groups' rows (their augmentation draws then depend on the layout).
Draws come from one generator per group, seeded by (seed +
1, g), the same on every rank of the group. On the card the steps replay
from CUDA graphs (one pool for every group) unless --eager is given; point
--save outside the repository.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from .convert import params_to_jax
from .cost.lut import lat_vectors_for_mc
from .data import (DataLoader, DevicePrefetcher, ImageList, device_normalizer,
                   image_decoder, synthetic_loader)
from .device import resolve_device
from .models.supernet import SuperNetwork
from .models.supernet_hybrid import HybridSuperNetwork
from .parallel.mesh import (local_device, make_mesh, maybe_distributed_init,
                            pair_seed)
from .parallel.pareto import (ParetoSearchState, init_pareto_state,
                              make_pareto_search_steps,
                              reset_group_optimizers)
from .search.compiled import GraphFamily, adopt, hold
from .search.parser import get_mc_num_dddict
from .search.train_step import cosine_lr_list
from .train_search import (GeneratorDraws, load_resume, masks_to_numpy,
                           rescale_widths, space_and_lut)
from .utils import (save_checkpoint_file, setup_experiment,
                    setup_rank_logging, to_numpy_tree, trace)

parser = argparse.ArgumentParser("pareto searching TF-NAS (PyTorch)")
parser.add_argument('--img_root', type=str, default='')
parser.add_argument('--train_list', type=str,
                    default="./dataset/ImageNet-100-effb0_train_cls_ratio0.8.txt")
parser.add_argument('--val_list', type=str,
                    default="./dataset/ImageNet-100-effb0_val_cls_ratio0.8.txt")
parser.add_argument('--lookup_path', type=str,
                    default="./latency_pkl/latency_tpu.pkl")
parser.add_argument('--save', type=str, default='./checkpoints')
parser.add_argument('--target_lats', type=str, default='0.6,0.8,1.0,1.2',
                    help='comma-separated target latencies, one search each')
parser.add_argument('--epochs', type=int, default=90)
parser.add_argument('--warmup_epochs', type=int, default=10)
parser.add_argument('--batch_size', type=int, default=32,
                    help='per-group batch size')
parser.add_argument('--w_lr', type=float, default=0.025)
parser.add_argument('--w_mom', type=float, default=0.9)
parser.add_argument('--w_wd', type=float, default=1e-5)
parser.add_argument('--a_lr', type=float, default=0.01)
parser.add_argument('--a_wd', type=float, default=5e-4)
parser.add_argument('--grad_clip', type=float, default=5.0)
parser.add_argument('--T', type=float, default=5.0)
parser.add_argument('--T_decay', type=float, default=0.96)
parser.add_argument('--num_classes', type=int, default=100)
parser.add_argument('--lambda_lat', type=float, default=0.1)
parser.add_argument('--seed', type=int, default=2)
parser.add_argument('--note', type=str, default='pareto')
parser.add_argument('--print_freq', type=int, default=100)
parser.add_argument('--workers', type=int, default=4)
parser.add_argument('--bf16', action='store_true', default=True)
parser.add_argument('--no_bf16', dest='bf16', action='store_false')
parser.add_argument('--space', type=str, default='mbconv',
                    choices=['mbconv', 'hybrid', 'tiny'])
parser.add_argument('--resume', type=str, default='',
                    help='resume: comma-separated per-group '
                         'searched_model_g{g}_{NN}.pkl paths (same order '
                         'as --target_lats), or one path pattern with {g}')
parser.add_argument('--synthetic', action='store_true')
parser.add_argument('--steps_per_epoch', type=int, default=0)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--eager', action='store_true',
                    help='run the steps eagerly on the card instead of '
                         'replaying them from CUDA graphs')


def make_batches(args, mesh, device=None):
    """epoch -> iterator of (x [L, B, H, W, 3], y [L, B]) batches: this
    rank's share of each of its L local groups' batches. Real lists decode
    for `device` (on the card for a CUDA device)."""
    if args.batch_size % mesh.data_size:
        raise SystemExit(f"--batch_size {args.batch_size} does not divide "
                         f"over a group's {mesh.data_size} ranks")
    local_bs = args.batch_size // mesh.data_size

    def synthetic(epoch):
        its = [synthetic_loader(args.batch_size, args.steps_per_epoch or 50,
                                args.num_classes, args.image_size,
                                seed=(epoch * 1000 + g, 0),
                                shard=(mesh.data_rank, mesh.data_size))
               for g in mesh.local_groups]
        for pairs in zip(*its):
            yield (np.stack([p[0] for p in pairs]),
                   np.stack([p[1] for p in pairs]))

    if args.synthetic:
        return synthetic
    ds = ImageList(args.img_root, args.train_list, training=True,
                   image_size=args.image_size,
                   host_shard=((mesh.data_rank, mesh.data_size)
                               if mesh.data_size > 1 else None),
                   device=device)
    G, L = mesh.groups, len(mesh.local_groups)
    # only the local groups' rows g::G are decoded, group by group
    dl = DataLoader(ds, local_bs * G, shuffle=True, num_workers=args.workers,
                    seed=args.seed, rows=[r for g in mesh.local_groups
                                          for r in range(g, local_bs * G, G)])

    def real(epoch):
        dl.set_epoch(epoch)
        it = iter(dl)
        if args.steps_per_epoch:
            it = itertools.islice(it, args.steps_per_epoch)
        for x, y in it:
            yield x.reshape(L, local_bs, *x.shape[1:]), y.reshape(L, local_bs)
    return real


def main(argv=None):
    args = parser.parse_args(argv)
    device = local_device(resolve_device(args.device))
    rank, world = maybe_distributed_init(device)
    targets = [float(t) for t in args.target_lats.split(',')]
    G = len(targets)
    mesh = make_mesh(world, G, rank)
    space, lat_lookup = space_and_lut(args)
    batches = make_batches(args, mesh, device)
    run_dir = [setup_experiment(args.save, 'pareto-search', args.note)
               if rank == 0 else None]
    if rank:
        setup_rank_logging(rank)
    if world > 1:  # the groups' first ranks write into rank 0's directory
        dist.broadcast_object_list(run_dir, src=0)
    run_dir = run_dir[0]
    logging.info("args = %s", args)
    if not args.synthetic:
        logging.info("image decode: %s", image_decoder(device))
    logging.info("rank %d of %d on %s: groups %s of %d, %d data ranks "
                 "each; targets %s", rank, world, device, mesh.local_groups,
                 G, mesh.data_size, targets)

    hybrid = args.space == 'hybrid'
    net = (HybridSuperNetwork(args.num_classes, bn_group=mesh.data_group)
           if hybrid else SuperNetwork(args.num_classes, space=space,
                                       bn_group=mesh.data_group))
    valid_mask = net.valid_mask(device) if hybrid else None
    local = list(mesh.local_groups)
    state = init_pareto_state(net, [
        torch.Generator(device=device).manual_seed(pair_seed(args.seed, g))
        for g in local])
    group_masks = [space.build_mc_mask_dddict() for _ in local]
    T = np.full((len(local),), args.T, np.float32)
    start_epoch = 0
    if args.resume:
        paths = ([args.resume.format(g=g) for g in range(G)]
                 if '{g}' in args.resume else args.resume.split(','))
        if len(paths) != G:
            raise SystemExit(f"need {G} resume paths, got {len(paths)}")
        for i, g in enumerate(local):
            (state.params[i], state.arch_params[i], group_masks[i],
             start_epoch, T[i]) = load_resume(paths[g], device)
        logging.info('resumed groups %s at epoch %d', local, start_epoch)

    family = (GraphFamily(device)
              if device.type == "cuda" and not args.eager else None)
    logging.info("steps: %s", "CUDA graphs" if family else "eager")
    weight_step, arch_step = make_pareto_search_steps(
        net, mesh, num_classes=args.num_classes, targets=targets,
        w_mom=args.w_mom, w_wd=args.w_wd, a_lr=args.a_lr, a_wd=args.a_wd,
        grad_clip=args.grad_clip, lambda_lat=args.lambda_lat,
        valid_mask=valid_mask, family=family)
    state = ParetoSearchState(*(adopt(family, list(f)) for f in state))
    draws = [GeneratorDraws(torch.Generator(device=device).manual_seed(
        pair_seed(args.seed + 1, g)), valid_mask) for g in local]
    lr = adopt(family, [torch.zeros((), device=device) for _ in local])
    T_dev = adopt(family, [torch.zeros((), device=device) for _ in local])
    base_lat = adopt(family, torch.tensor(float(lat_lookup["base"]),
                                          device=device))
    key_dddict = space.build_lat_lookup_key_dddict()
    lr_list = cosine_lr_list(args.w_lr, args.epochs)
    prep = device_normalizer(torch.bfloat16 if args.bf16 else torch.float32)
    masks = update_masks = lat_vecs = None

    total_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        trace.reset()  # traced runs keep one epoch of spans in memory
        # the captured steps read these buffers in place
        masks = hold(family, masks, [net.device_masks(m, device)
                                     for m in group_masks])
        update_masks = hold(family, update_masks, [
            net.update_masks(p, m)
            for p, m in zip(state.params, group_masks)])
        lat_vecs = hold(family, lat_vecs, [
            torch.from_numpy(lat_vectors_for_mc(
                lat_lookup, get_mc_num_dddict(m), key_dddict,
                space.NUM_OPS)).to(device) for m in group_masks])
        reset_group_optimizers(state)
        for i in range(len(local)):
            lr[i].fill_(lr_list[epoch])
            T_dev[i].fill_(float(T[i]))
        warm = epoch < args.warmup_epochs
        logging.info('Epoch: %d lr: %e T: %s', epoch, lr_list[epoch],
                     T.tolist())
        macc = torch.zeros(len(local), device=device)
        n = 0
        for step, (x, y) in enumerate(DevicePrefetcher(batches(epoch),
                                                       device)):
            xs, ys = prep(x), y
            pairs = []
            for d, a in zip(draws, state.arch_params):
                idx_g = d.gumbel(a["log_alphas"])
                pairs.append((idx_g, d.partner(idx_g, space.NUM_OPS)))
            state, m = weight_step(state, masks, update_masks, xs, ys, lr,
                                   pairs)
            macc += m["loss"]
            n += 1
            if not warm and step % 2 == 0:
                us = [d.uniform(a["log_alphas"].shape)
                      for d, a in zip(draws, state.arch_params)]
                state, _ = arch_step(state, masks, xs, ys, lat_vecs,
                                     base_lat, T_dev, us)
            if step % args.print_freq == 0:
                logging.info('TRAIN Step %04d loss %s', step,
                             m["loss"].cpu().numpy().round(4).tolist())
        logging.info('Train loss %s', (macc / max(n, 1)).tolist())
        if not warm:
            T *= np.float32(args.T_decay)

        for i, g in enumerate(local):
            if not warm:
                group_masks[i], before, after = rescale_widths(
                    state.arch_params[i], state.params[i], group_masks[i],
                    space, lat_lookup, targets[g])
                logging.info('group %d (target %.3f): lat %.4f -> %.4f', g,
                             targets[g], before, after)
            if mesh.data_rank:
                continue
            save_checkpoint_file(to_numpy_tree({
                "params": params_to_jax(state.params[i]),
                "arch_params": state.arch_params[i],
                "mc_mask_dddict": masks_to_numpy(group_masks[i]),
                "epoch": epoch + 1,
                "T": float(T[i]),
                "target_lat": targets[g],
            }), f"{run_dir}/searched_model_g{g}_{epoch + 1:02d}.pkl")

    if family is not None:
        for gr in family.graphs:
            logging.info("graph %s: built in %.1fs, %d replays, kernel "
                         "nodes %s", gr.name, gr.build_s, gr.replays, gr.nodes)
    logging.info('Total pareto searching time: %ds',
                 time.time() - total_start)
    return run_dir


if __name__ == '__main__':
    main()
