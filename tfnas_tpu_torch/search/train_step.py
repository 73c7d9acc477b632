"""The bi-level search steps (counterpart of tfnas_tpu/search/train_step.py).

Optimisers follow PyTorch's semantics as the JAX package writes them out:
- weights: clip by global norm -> grad + wd * p -> momentum buffer ->
  p - lr * buf * update_mask, so masked channels stay exactly frozen;
- arch: Adam (betas 0.5/0.999, L2 decay in the gradient) with the same clip,
  then the log-softmax projection of log_alphas and of every stage's betas.

Parameter trees are nested dicts of tensors. The step functions are
functional: they return new trees and leave their arguments unchanged.
Random draws enter as arguments (search/bisample.py makes them), so a step
is a deterministic function of its inputs. Metrics stay on the device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..utils.metrics import accuracy, cross_entropy, masked_mean, nll
from .bisample import gumbel_softmax_weights, project_log_softmax


# -- trees -------------------------------------------------------------------

def tree_leaves(tree):
    """Leaves of a nested dict in insertion order (None leaves skipped)."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like `tree` holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def zeros_like_tree(tree):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), tree)


def value_and_grad(loss_fn, tree):
    """(loss_fn(tree), d loss / d tree) for a loss_fn returning
    (loss, aux); aux is returned beside the loss."""
    leaves = [l.detach().requires_grad_() for l in tree_leaves(tree)]
    loss, aux = loss_fn(tree_unflatten(tree, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return (loss.detach(), aux), tree_unflatten(tree, grads)


# -- optimisers --------------------------------------------------------------

def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """clip_grad_norm_ semantics: scale by max_norm / (norm + 1e-6) when
    that is below 1."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def sgd_momentum_update(params, grads, mom, update_masks, *, lr, momentum,
                        weight_decay, grad_clip):
    """One masked SGD + momentum step (dampening 0). update_masks leaves
    multiply the step; None leaves update everywhere."""
    grads, _ = clip_by_global_norm(grads, grad_clip)
    d = tree_map(lambda g, p: g + weight_decay * p.float(), grads, params)
    mom = tree_map(lambda m, u: momentum * m + u, mom, d)

    def step(p, m, km):
        delta = lr * m
        return p - (delta if km is None else delta * km)
    params = tree_map(step, params, mom, update_masks)
    return params, mom


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam_init(params):
    return AdamState(0, zeros_like_tree(params), zeros_like_tree(params))


def adam_update(params, grads, st, *, lr, b1, b2, eps, weight_decay,
                grad_clip):
    """Adam with L2 weight decay folded into the gradient."""
    grads, _ = clip_by_global_norm(grads, grad_clip)
    grads = tree_map(lambda g, p: g + weight_decay * p.float(), grads, params)
    step = st.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, st.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, st.nu, grads)
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    params = tree_map(
        lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
        params, mu, nu)
    return params, AdamState(step, mu, nu)


# -- search steps ------------------------------------------------------------

class SearchStepFns(NamedTuple):
    warmup_step: Any
    weight_step: Any
    arch_step: Any
    val_step: Any


def make_search_steps(net, *, num_classes, w_mom=0.9, w_wd=1e-5, a_lr=0.01,
                      a_beta1=0.5, a_beta2=0.999, a_wd=5e-4, grad_clip=5.0,
                      lambda_lat=0.1, target_lat=15.0, lat_under_boost=1.0):
    """The step functions for SuperNetwork `net`:

    warmup_step(params, arch_params, mom, masks, update_masks, x, y, lr,
                idx_g) -> (params, mom, metrics)
    weight_step(..., lr, idx_g, idx_r) -> (params, mom, metrics)
    arch_step(params, arch_params, opt_a, masks, x, y, lat_vec, base_lat,
              temperature, gumbel_u) -> (arch_params, opt_a, metrics)
    val_step(params, arch_params, masks, x, y, idx_g, wmask=None) -> metrics

    x: [N, H, W, 3] in the compute dtype; y: int [N]; idx_*: int [18] op
    indices; gumbel_u: the [18, 8] uniform draw of the Gumbel noise."""
    del num_classes  # the logits carry it

    def _weight_update(params, mom, update_masks, grads, lr):
        return sgd_momentum_update(params, grads, mom, update_masks, lr=lr,
                                   momentum=w_mom, weight_decay=w_wd,
                                   grad_clip=grad_clip)

    def _metrics(loss, logits, y):
        top1, top5 = accuracy(logits.detach(), y, topk=(1, 5))
        return {"loss": loss, "top1": top1, "top5": top5}

    def warmup_step(params, arch_params, mom, masks, update_masks, x, y, lr,
                    idx_g):
        def loss_fn(p):
            logits = net.apply_sampled(p, arch_params, masks, x, idx_g)
            return cross_entropy(logits, y), logits
        (loss, logits), grads = value_and_grad(loss_fn, params)
        params, mom = _weight_update(params, mom, update_masks, grads, lr)
        return params, mom, _metrics(loss, logits, y)

    def weight_step(params, arch_params, mom, masks, update_masks, x, y, lr,
                    idx_g, idx_r):
        def loss_fn(p):
            logits_g, logits_r = net.apply_sampled_pair(
                p, arch_params, masks, x, idx_g, idx_r)
            return (cross_entropy(logits_g, y) + cross_entropy(logits_r, y),
                    logits_g)
        (loss, logits), grads = value_and_grad(loss_fn, params)
        params, mom = _weight_update(params, mom, update_masks, grads, lr)
        return params, mom, _metrics(loss, logits, y)

    def arch_step(params, arch_params, opt_a, masks, x, y, lat_vec,
                  base_lat, temperature, gumbel_u):
        params = tree_map(torch.Tensor.detach, params)

        def loss_fn(a):
            w = gumbel_softmax_weights(a["log_alphas"], temperature,
                                       gumbel_u)
            logits, lat = net.apply_soft(params, a, masks, x, w, lat_vec)
            lat = lat + base_lat
            loss_a = cross_entropy(logits, y)
            # |lat / target - 1| * lambda; lat_under_boost scales the
            # under-target side (1.0 = the reference's symmetric form)
            dev = lat / target_lat - 1.0
            loss_l = torch.where(dev < 0.0, -dev * lat_under_boost,
                                 dev) * lambda_lat
            return loss_a + loss_l, (loss_a.detach(), loss_l.detach(),
                                     lat.detach())
        (_, (loss_a, loss_l, lat)), grads = value_and_grad(loss_fn,
                                                           arch_params)
        arch_params, opt_a = adam_update(
            arch_params, grads, opt_a, lr=a_lr, b1=a_beta1, b2=a_beta2,
            eps=1e-8, weight_decay=a_wd, grad_clip=grad_clip)
        arch_params = {
            "log_alphas": project_log_softmax(arch_params["log_alphas"]),
            "betas": {k: torch.log_softmax(v, dim=-1)
                      for k, v in arch_params["betas"].items()},
        }
        return arch_params, opt_a, {"loss_a": loss_a, "loss_l": loss_l,
                                    "lat": lat}

    @torch.no_grad()
    def val_step(params, arch_params, masks, x, y, idx_g, wmask=None):
        """Sampled validation; BN stays in batch-stat mode, as the
        reference validates in train mode. wmask: optional [N] 0/1 mask of
        valid samples in a padded tail batch."""
        logits = net.apply_sampled(params, arch_params, masks, x, idx_g)
        per = nll(logits, y)
        loss = per.mean() if wmask is None else masked_mean(per, wmask)
        top1, top5 = accuracy(logits, y, topk=(1, 5), weights=wmask)
        return {"loss": loss, "top1": top1, "top5": top5}

    return SearchStepFns(warmup_step, weight_step, arch_step, val_step)


def cosine_lr_list(base_lr, epochs):
    """Per-epoch cosine lr (CosineAnnealingLR's closed form)."""
    return [base_lr * (1 + math.cos(math.pi * e / epochs)) / 2
            for e in range(epochs)]
