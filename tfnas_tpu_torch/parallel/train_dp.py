"""Eval-network training and validation steps (counterpart of
tfnas_tpu/parallel/train_dp.py).

Data-parallel over the ranks of a process group, one process per card (the
reference's NCCL DDP with apex sync-BN, train_eval_amp.py:121-222): each
rank takes its share of the global batch, BN takes its moments over the
global batch (ops/batchnorm.py), and the gradients, loss and accuracies are
averaged over the ranks by one collective per step, so a step over N ranks
is the one-process step on the global batch. Validation sums its weighted
sums and its count over the ranks. Without a group the steps are those of
one process. Activations run in the compute dtype (bf16 by default) with
f32 parameters and f32 BN statistics.

Optimiser: SGD momentum 0.9, weight decay 1e-5, gradient clip 5.0 by
global norm (search/train_step.py's sgd_momentum_update with every entry
updated), label smoothing 0.1, per-epoch cosine lr with a 5-epoch linear
warmup when the batch exceeds 256.

The eager train step's phases are device spans (utils/trace.py):
`tfnas.train.forward` (apply and loss), `tfnas.train.backward` (the
gradients) and `tfnas.train.update` (accuracy, the group mean and SGD).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..search.train_step import (grad_leaves, grad_tree, mean_over_group,
                                 sgd_momentum_update, tree_map,
                                 tree_unflatten, zeros_like_tree)
from ..utils import trace
from ..utils.metrics import accuracy, cross_entropy_label_smooth, nll
from .mesh import all_reduce_sum


class EvalTrainState(NamedTuple):
    params: Any
    bn_state: Any
    momentum: Any
    epoch: int


def init_eval_train_state(net, generator):
    params, bn_state = net.init(generator)
    return EvalTrainState(params=params, bn_state=bn_state,
                          momentum=zeros_like_tree(params), epoch=0)


def make_eval_steps(net, *, num_classes, label_smooth=0.1, momentum=0.9,
                    weight_decay=1e-5, grad_clip=5.0,
                    compute_dtype=torch.bfloat16, group=None):
    """(train_step, val_step) for EvalNetwork `net`:

    train_step(state, x, y, lr, keep=None) -> (state, metrics)
    val_step(state, x, y, wmask=None) -> metrics

    x: [N, H, W, 3] (cast to the compute dtype), this rank's share of the
    batch; y: int [N]; keep: the drop-connect and dropout draws of
    `net.draw_keep` (each rank draws its own); wmask: [N] 0/1 validity of
    a padded final batch. group: the process group the steps are
    data-parallel over (None: one process). Metrics stay on the device;
    val_step's `count` is the number of valid samples it scored over all
    ranks."""

    def train_step(state, x, y, lr, keep=None):
        def loss_fn(p):
            logits, new_bn = net.apply(p, state.bn_state, x.to(compute_dtype),
                                       training=True, keep=keep,
                                       bn_group=group)
            loss = cross_entropy_label_smooth(logits, y, num_classes,
                                              label_smooth)
            return loss, (logits.detach(),
                          tree_map(torch.Tensor.detach, new_bn))

        # value_and_grad(loss_fn, state.params), split at loss_fn's return
        with trace.span("tfnas.train.forward", device=True):
            leaves = grad_leaves(state.params)
            loss, (logits, new_bn) = loss_fn(
                tree_unflatten(state.params, leaves))
        with trace.span("tfnas.train.backward", device=True):
            grads = grad_tree(loss, state.params, leaves)
        with trace.span("tfnas.train.update", device=True):
            loss = loss.detach()
            top1, top5 = accuracy(logits, y, topk=(1, 5))
            grads, metrics = mean_over_group(
                group, grads, {"loss": loss, "top1": top1, "top5": top5})
            params, mom = sgd_momentum_update(
                state.params, grads, state.momentum,
                tree_map(lambda p: None, state.params), lr=lr,
                momentum=momentum, weight_decay=weight_decay,
                grad_clip=grad_clip)
        return EvalTrainState(params, new_bn, mom, state.epoch), metrics

    @torch.no_grad()
    def val_step(state, x, y, wmask=None):
        """Eval-mode metrics as weighted sums over the valid samples of
        every rank: sum(w * value) / max(sum(w), 1), exact over a padded
        set."""
        logits, _ = net.apply(state.params, state.bn_state,
                              x.to(compute_dtype), training=False)
        per = nll(logits, y)
        w = (torch.ones(y.shape, device=logits.device) if wmask is None
             else wmask.float())
        pred = torch.topk(logits, 5, dim=-1).indices
        correct = (pred == y[:, None]).float() * w[:, None]
        sums = torch.stack([(per * w).sum(), correct[:, :1].sum(),
                            correct.sum(), w.sum()])
        if group is not None:
            sums = all_reduce_sum(sums, group)
        wsum = torch.clamp(sums[3], min=1.0)
        return {"loss": sums[0] / wsum, "top1": sums[1] / wsum * 100.0,
                "top5": sums[2] / wsum * 100.0, "count": sums[3]}

    return train_step, val_step


def cosine_lr_with_warmup(base_lr, epochs, epoch, batch_size,
                          warmup_epochs=5):
    """Per-epoch lr: closed-form cosine, times a linear warmup over the
    first `warmup_epochs` epochs when batch_size > 256."""
    lr = base_lr * (1 + math.cos(math.pi * epoch / epochs)) / 2
    if epoch < warmup_epochs and batch_size > 256:
        lr = lr * (epoch + 1) / warmup_epochs
    return float(lr)
