"""Process groups for data parallelism and the Pareto search (counterpart
of tfnas_tpu/parallel/mesh.py).

The JAX package runs one program over a device mesh ('pareto', 'data');
XLA inserts the all-reduces. Here, as in the reference's NCCL DDP
(train_eval_amp.py:121-222), there is one process per card, launched by
torchrun, and the collectives are explicit `torch.distributed` calls: NCCL
between cards, gloo on the CPU.

A Pareto search of G groups on `world` ranks is laid out as the JAX mesh
is: with world >= G (world % G == 0) group g runs on ranks
[g * world / G, (g + 1) * world / G), data-parallel over them; with world <
G (G % world == 0) each rank holds G / world whole groups and runs them one
after another, as a JAX device runs its local slice of the group axis.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def local_device(device):
    """The card of this process: cuda:LOCAL_RANK under torchrun (made the
    current device), else `device` unchanged."""
    device = torch.device(device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    return device


def maybe_distributed_init(device):
    """Join the process group that torchrun's environment describes (NCCL
    for a CUDA device, gloo on the CPU) and return (rank, world). Without
    that environment: (0, 1), and nothing is initialised."""
    if not any(v in os.environ for v in _LAUNCH_ENV):
        return 0, 1
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if v not in os.environ]
    if missing:
        raise RuntimeError(f"a multi-process launch needs {missing} in the "
                           f"environment, as torchrun sets them")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"),
            rank=rank, world_size=world)
    return rank, world


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard():
    """(rank, world) for ImageList's host sharding; None in one process,
    which keeps the single-process loaders as they are."""
    rank, world = _rank_world()
    return None if world == 1 else (rank, world)


def is_main_process():
    """Gates log files and checkpoint writes (rank 0)."""
    return _rank_world()[0] == 0


def pair_seed(seed, index):
    """A seed from (seed, index): the stream of a Pareto group, or of a
    data-parallel rank other than 0 (the counterpart of JAX's
    fold_in(key, index))."""
    return int(np.random.SeedSequence((seed, index)).generate_state(1)[0])


class ParetoMesh(NamedTuple):
    """This rank's place in a Pareto layout of `groups` searches."""
    groups: int
    local_groups: tuple     # the group indices this rank runs
    data_group: Any         # the group's process group; None on one rank
    data_rank: int          # this rank's index among its group's ranks
    data_size: int          # the ranks of one group


def make_mesh(world=None, pareto_groups=1, rank=None):
    """This rank's ParetoMesh. Every rank calls it with the same arguments:
    the data process groups of all groups are created (dist.new_group) in
    the same order on every rank. One group over all ranks uses the world
    group."""
    r, w = _rank_world()
    world = w if world is None else world
    rank = r if rank is None else rank
    G = pareto_groups
    if world < G:
        if G % world:
            raise ValueError(f"{G} pareto groups do not divide over "
                             f"{world} ranks")
        per = G // world
        return ParetoMesh(G, tuple(range(rank * per, (rank + 1) * per)),
                          None, 0, 1)
    if world % G:
        raise ValueError(f"{G} pareto groups must divide {world} ranks")
    size = world // G
    group = None
    if size > 1 and size == world:
        group = dist.group.WORLD
    elif size > 1:
        for g in range(G):
            pg = dist.new_group(list(range(g * size, (g + 1) * size)))
            if g == rank // size:
                group = pg
    return ParetoMesh(G, (rank // size,), group, rank % size, size)


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the cotangent over
    the ranks too (the transpose of JAX's psum under shard_map), so each
    rank's input receives the gradient of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """Differentiable sum of x over the ranks of `group`. A plain in-place
    all_reduce would hand each rank only its own loss's gradient and drop
    the cross-rank terms of cross-replica BN."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(tensors, group):
    """The mean over the group's ranks of every tensor in `tensors`, by one
    collective over one flat f32 buffer (not differentiable: for gradients
    and metrics). The results are copied out of the buffer into tensors of
    their own: a multi-tensor kernel (the optimisers' norms) picks its
    order of summation by the alignment of each tensor, so views at odd
    offsets would round otherwise than the inputs."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [c.view_as(t).to(t.dtype, copy=True)
            for c, t in zip(flat.split([t.numel() for t in tensors]),
                            tensors)]
