"""G searches at once, one per target latency (counterpart of
tfnas_tpu/parallel/pareto.py; BASELINE config 5).

The JAX package stacks the G groups' state along a leading [G] axis,
shards it over the mesh's 'pareto' axis and vmaps the step over each
device's local groups. Here each rank holds one state tree per local
group (parallel/mesh.py lays the groups out over the ranks) and runs the
groups' steps one after another. Within a group the batch is
data-parallel over the group's ranks: BN statistics, gradients and losses
are taken over the group's global batch through its process group.

Every step is the single search's (search/train_step.py), with the group's
target: the weight step runs the bi-sampling pair through
apply_sampled_pair and a masked SGD update; the arch step the soft forward
with the loss |lat / target_g - 1| * lambda (no under-target boost), Adam
and the log-softmax projection. Draws are arguments. All data ranks of a
group must make the same draws, from a generator seeded by the group
(mesh.pair_seed), never by the rank: ranks that drew different ops would
average the gradients of different subnetworks, and nothing would fail.

With a GraphFamily every group's steps replay from their own CUDA graphs,
all in that family: one memory pool for every group's intermediates.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..convert import stack_group_trees
from ..search.compiled import leaves_of
from ..search.train_step import adam_init, make_search_steps, zeros_like_tree

__all__ = ["ParetoSearchState", "init_pareto_state", "stack_group_trees",
           "reset_group_optimizers", "make_pareto_search_steps"]


class ParetoSearchState(NamedTuple):
    """Lists with one entry per local group (mesh.local_groups order)."""
    params: Any
    arch_params: Any
    momentum: Any
    opt_a: Any


def init_pareto_state(net, generators):
    """One supernet state per generator: one generator per local group,
    seeded by the group, so that all of a group's ranks start alike."""
    params, arch = zip(*(net.init(g) for g in generators))
    return ParetoSearchState(list(params), list(arch),
                             [zeros_like_tree(p) for p in params],
                             [adam_init(a) for a in arch])


def reset_group_optimizers(state):
    """Fresh per-epoch optimisers (the reference recreates them every
    epoch): momentum and Adam state zeroed in place, so that captured
    steps keep reading the same buffers."""
    torch._foreach_zero_(leaves_of(state.momentum) + leaves_of(state.opt_a))
    return state


def _at(value, i):
    return value[i] if isinstance(value, (list, tuple)) else value


def make_pareto_search_steps(net, mesh, *, num_classes, targets, w_mom=0.9,
                             w_wd=1e-5, a_lr=0.01, a_beta1=0.5,
                             a_beta2=0.999, a_wd=5e-4, grad_clip=5.0,
                             lambda_lat=0.1, valid_mask=None, family=None):
    """(weight_step, arch_step) over a ParetoSearchState of this rank's
    groups (`mesh`: parallel.mesh.ParetoMesh; `net` built with
    bn_group=mesh.data_group):

    weight_step(state, masks, update_masks, xs, ys, lr, draws)
        -> (state, {loss, top1, top5: [local groups]})
    arch_step(state, masks, xs, ys, lat_vecs, base_lat, T, gumbel_us)
        -> (state, {loss_a, loss_l, lat: [local groups]})

    Per local group i: masks[i], update_masks[i], lat_vecs[i] (its own
    widths), xs[i] [N, H, W, 3] and ys[i] (this rank's share of the
    group's batch), draws[i] = (idx_g, idx_r), gumbel_us[i] the [18, O]
    uniform of its Gumbel noise. lr and T: one value for every group or a
    list with one per group. targets: the G target latencies (ms).
    valid_mask: the hybrid space's [18, 9] candidate mask, shared by the
    groups. family: as make_search_steps; every group's graphs share
    it."""
    groups = [make_search_steps(
        net, num_classes=num_classes, w_mom=w_mom, w_wd=w_wd, a_lr=a_lr,
        a_beta1=a_beta1, a_beta2=a_beta2, a_wd=a_wd, grad_clip=grad_clip,
        lambda_lat=lambda_lat, target_lat=float(targets[g]),
        family=family, valid_mask=valid_mask,
        group=mesh.data_group) for g in mesh.local_groups]

    def _stack(metrics):
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def weight_step(state, masks, update_masks, xs, ys, lr, draws):
        params, mom, metrics = zip(*(
            s.weight_step(state.params[i], state.arch_params[i],
                          state.momentum[i], masks[i], update_masks[i],
                          xs[i], ys[i], _at(lr, i), *draws[i])
            for i, s in enumerate(groups)))
        return (state._replace(params=list(params), momentum=list(mom)),
                _stack(metrics))

    def arch_step(state, masks, xs, ys, lat_vecs, base_lat, T, gumbel_us):
        arch, opt_a, metrics = zip(*(
            s.arch_step(state.params[i], state.arch_params[i],
                        state.opt_a[i], masks[i], xs[i], ys[i], lat_vecs[i],
                        base_lat, _at(T, i), gumbel_us[i])
            for i, s in enumerate(groups)))
        return (state._replace(arch_params=list(arch), opt_a=list(opt_a)),
                _stack(metrics))

    return weight_step, arch_step
