"""The bi-level search steps (counterpart of tfnas_tpu/search/train_step.py).

Optimisers follow PyTorch's semantics as the JAX package writes them out:
- weights: clip by global norm -> grad + wd * p -> momentum buffer ->
  p - lr * buf * update_mask, so masked channels stay exactly frozen;
- arch: Adam (betas 0.5/0.999, L2 decay in the gradient) with the same clip,
  then the log-softmax projection of log_alphas and of every stage's betas.

Parameter trees are nested dicts of tensors. The step functions are
functional: they return new trees and leave their arguments unchanged.
Steps made with capture=True are not: on the card they return static
buffers that the next replay overwrites (search/compiled.py).
Random draws enter as arguments (search/bisample.py makes them), so a step
is a deterministic function of its inputs. Metrics stay on the device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..parallel.mesh import all_reduce_mean
from ..utils.metrics import accuracy, cross_entropy, masked_mean, nll
from .bisample import (gumbel_softmax_weights, gumbel_uniform,
                       project_log_softmax, sample_gumbel_indices,
                       sample_random_excluding)
from .compiled import AutoGraphed, SharedFamily


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


def mean_over_group(group, grads, metrics):
    """(grads, metrics) averaged over the ranks of `group` by one
    collective over one flat buffer (the data-parallel pmean of the JAX
    steps); unchanged when group is None. metrics: a dict of 0-dim
    tensors."""
    if group is None:
        return grads, metrics
    leaves = tree_leaves(grads)
    out = all_reduce_mean(leaves + list(metrics.values()), group)
    return (tree_unflatten(grads, out[:len(leaves)]),
            dict(zip(metrics, out[len(leaves):])))


def value_and_grad(loss_fn, tree):
    """(loss_fn(tree), d loss / d tree) for a loss_fn returning
    (loss, aux); aux is returned beside the loss."""
    leaves = grad_leaves(tree)
    loss, aux = loss_fn(tree_unflatten(tree, leaves))
    grads = grad_tree(loss, tree, leaves)
    return (loss.detach(), aux), grads


def grad_leaves(tree):
    """The leaves of `tree`, detached, that a loss is differentiated by."""
    return [l.detach().requires_grad_() for l in tree_leaves(tree)]


def grad_tree(loss, tree, leaves):
    """d loss / d `leaves` (grad_leaves(tree)) in `tree`'s structure,
    zeros where the loss does not depend on a leaf."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return tree_unflatten(tree, grads)


# -- optimisers --------------------------------------------------------------
#
# Every update runs over all leaves at once with torch._foreach_* (a few
# multi-tensor launches on the card instead of several per leaf). The
# elementwise order of operations is the per-leaf one of the JAX package, so
# the results do not depend on how the leaves are grouped. The step scalars
# (lr, Adam's step count) may be 0-dim device tensors: nothing here reads a
# device value on the host, so a step can be captured in a CUDA graph.

def _leaves_f32(tree):
    return [l.float() for l in tree_leaves(tree)]


def _aligned(ref, tree):
    """Leaves of `tree` (None kept) in the key order of `ref`: trees made
    apart, as a checkpoint's params and the update masks, may order their
    keys differently."""
    if isinstance(ref, dict):
        return [l for k, v in ref.items() for l in _aligned(v, tree[k])]
    return [tree]


def _rebuild(like, ref, leaves):
    """A tree in `like`'s key order holding `leaves`, given in `ref`'s."""
    return tree_map(lambda _, v: v, like, tree_unflatten(ref, leaves))


def global_norm(tree):
    """sqrt(sum of squares) over every leaf, in f32."""
    norms = torch._foreach_norm(_leaves_f32(tree))
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree, max_norm):
    """clip_grad_norm_ semantics: scale by max_norm / (norm + 1e-6) when
    that is below 1."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_unflatten(tree, torch._foreach_mul(tree_leaves(tree),
                                                   scale)), norm


def _decayed(grads, params, weight_decay):
    """g + weight_decay * p over the leaves (product, then sum), in the
    key order of params."""
    return torch._foreach_add(
        _aligned(params, grads),
        torch._foreach_mul(_leaves_f32(params), weight_decay))


def sgd_momentum_update(params, grads, mom, update_masks, *, lr, momentum,
                        weight_decay, grad_clip):
    """One masked SGD + momentum step (dampening 0). update_masks leaves
    multiply the step; None leaves update everywhere. lr: a float or a 0-dim
    tensor."""
    grads, _ = clip_by_global_norm(grads, grad_clip)
    d = _decayed(grads, params, weight_decay)
    m = torch._foreach_add(
        torch._foreach_mul(_aligned(params, mom), momentum), d)
    delta = list(torch._foreach_mul(m, lr))
    km = _aligned(params, update_masks)
    masked = [i for i, k in enumerate(km) if k is not None]
    if masked:
        for i, v in zip(masked, torch._foreach_mul(
                [delta[i] for i in masked], [km[i] for i in masked])):
            delta[i] = v
    p = torch._foreach_sub(tree_leaves(params), delta)
    return tree_unflatten(params, p), _rebuild(mom, params, m)


class AdamState(NamedTuple):
    step: Any  # 0-dim f32 tensor: the count of updates taken
    mu: Any
    nu: Any


def adam_init(params):
    dev = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), device=dev), zeros_like_tree(params),
                     zeros_like_tree(params))


def adam_update(params, grads, st, *, lr, b1, b2, eps, weight_decay,
                grad_clip):
    """Adam with L2 weight decay folded into the gradient. The bias
    corrections 1 - b ** step are taken in f64 on the device and rounded
    to f32, as a host-side Python float would be."""
    grads, _ = clip_by_global_norm(grads, grad_clip)
    g = _decayed(grads, params, weight_decay)
    step = st.step + 1
    mu = torch._foreach_add(torch._foreach_mul(_aligned(params, st.mu), b1),
                            torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_add(
        torch._foreach_mul(_aligned(params, st.nu), b2),
        torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
    bc1 = (1 - b1 ** step.double()).float()
    bc2 = (1 - b2 ** step.double()).float()
    upd = torch._foreach_div(
        torch._foreach_mul(torch._foreach_div(mu, bc1), lr),
        torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                           eps))
    p = torch._foreach_sub(tree_leaves(params), upd)
    return tree_unflatten(params, p), AdamState(
        step, _rebuild(st.mu, params, mu), _rebuild(st.nu, params, nu))


# -- search steps ------------------------------------------------------------

class SearchStepFns(NamedTuple):
    warmup_step: Any
    weight_step: Any
    arch_step: Any
    val_step: Any


def make_search_steps(net, *, num_classes, w_mom=0.9, w_wd=1e-5, a_lr=0.01,
                      a_beta1=0.5, a_beta2=0.999, a_wd=5e-4, grad_clip=5.0,
                      lambda_lat=0.1, target_lat=15.0, lat_under_boost=1.0,
                      capture=False, family=None, valid_mask=None,
                      group=None):
    """The step functions for SuperNetwork `net`:

    warmup_step(params, arch_params, mom, masks, update_masks, x, y, lr,
                idx_g) -> (params, mom, metrics)
    weight_step(..., lr, idx_g, idx_r) -> (params, mom, metrics)
    arch_step(params, arch_params, opt_a, masks, x, y, lat_vec, base_lat,
              temperature, gumbel_u) -> (arch_params, opt_a, metrics)
    val_step(params, arch_params, masks, x, y, idx_g, wmask=None) -> metrics

    x: [N, H, W, 3] in the compute dtype; y: int [N]; idx_*: int [18] op
    indices; gumbel_u: the [18, 8] uniform draw of the Gumbel noise; lr,
    base_lat, temperature: floats or 0-dim tensors.

    capture mirrors the JAX package's jit=: with capture=True, the warmup,
    weight and arch steps called with tensors on the card are each replayed
    from a CUDA graph (search/compiled.py; their outputs are then static
    buffers that the next replay overwrites, so a caller that keeps a
    step's result clones it first). On the CPU they run eagerly.
    family: the GraphFamily whose pool and buffers the graphs share (or a
    SharedFamily, to share one made at the first capture with other
    steps).
    valid_mask: optional 0/1 [18, NUM_OPS] tensor of the candidate slots
    each block offers (the hybrid conv/ViT space): invalid slots get zero
    soft weight and the projection pins them to a sentinel. The hard draws
    are arguments; make them with the same mask (search/bisample.py).
    group: the process group the steps are data-parallel over (the ranks
    of one Pareto group; `net` then takes its BN statistics over it too):
    the weight steps average their gradients, loss and accuracies over its
    ranks and the arch step its gradients and loss_a, by one collective
    each. Every rank must then make the same draws.

    Raises ValueError for capture=True with a net built with
    cond_width_split: it reads each sampled op index on the host, which a
    graph cannot (the JAX package forbids it under vmap)."""
    del num_classes  # the logits carry it
    if capture and net.cond_width_split:
        raise ValueError("cond_width_split reads every sampled op index on "
                         "the host, so its steps cannot be captured: make "
                         "them with capture=False")

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
        grads, metrics = mean_over_group(group, grads,
                                         _metrics(loss, logits, y))
        params, mom = _weight_update(params, mom, update_masks, grads, lr)
        return params, mom, metrics

    def weight_step(params, arch_params, mom, masks, update_masks, x, y, lr,
                    idx_g, idx_r):
        def loss_fn(p):
            logits_g, logits_r = net.apply_sampled_pair(
                p, arch_params, masks, x, idx_g, idx_r)
            return (cross_entropy(logits_g, y) + cross_entropy(logits_r, y),
                    logits_g)
        (loss, logits), grads = value_and_grad(loss_fn, params)
        grads, metrics = mean_over_group(group, grads,
                                         _metrics(loss, logits, y))
        params, mom = _weight_update(params, mom, update_masks, grads, lr)
        return params, mom, metrics

    def arch_step(params, arch_params, opt_a, masks, x, y, lat_vec,
                  base_lat, temperature, gumbel_u):
        params = tree_map(torch.Tensor.detach, params)

        def loss_fn(a):
            w = gumbel_softmax_weights(a["log_alphas"], temperature,
                                       gumbel_u, valid_mask)
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
        # loss_l and lat are functions of the arch params alone: the same
        # on every rank
        grads, metrics = mean_over_group(group, grads, {"loss_a": loss_a})
        arch_params, opt_a = adam_update(
            arch_params, grads, opt_a, lr=a_lr, b1=a_beta1, b2=a_beta2,
            eps=1e-8, weight_decay=a_wd, grad_clip=grad_clip)
        arch_params = {
            "log_alphas": project_log_softmax(arch_params["log_alphas"],
                                              valid_mask),
            "betas": {k: torch.log_softmax(v, dim=-1)
                      for k, v in arch_params["betas"].items()},
        }
        return arch_params, opt_a, {"loss_a": metrics["loss_a"],
                                    "loss_l": loss_l, "lat": lat}

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

    if not capture:
        return SearchStepFns(warmup_step, weight_step, arch_step, val_step)
    shared = family if isinstance(family, SharedFamily) else \
        SharedFamily(family)
    return SearchStepFns(
        AutoGraphed(warmup_step, {0: 0, 1: 2}, "warmup_step", shared),
        AutoGraphed(weight_step, {0: 0, 1: 2}, "weight_step", shared),
        AutoGraphed(arch_step, {0: 1, 1: 2}, "arch_step", shared),
        val_step)


def make_scanned_search_iter(net, *, num_classes, arch_every=2, steps=None,
                             **kw):
    """K search units per call, each `arch_every` bi-sampling weight steps
    followed by one soft arch step (the JAX package's
    make_scanned_search_iter):

      run(params, mom, arch_params, opt_a, masks, update_masks,
          xw [K, arch_every, N, H, W, C], yw [K, arch_every, N],
          xa [K, N, H, W, C], ya [K, N], lr, T, lat_vec, base_lat, draws)
      -> (params, mom, arch_params, opt_a, wmetrics, ametrics)

    wmetrics: {loss, top1, top5, idx_g, idx_r} stacked [K, arch_every, ...];
    ametrics: {loss_a, loss_l, lat, gumbel_u} stacked [K, ...].

    draws: a torch.Generator, from which every weight step draws its gumbel
    pick and then its partner and every arch step the uniform of its Gumbel
    noise, in that order (the order of the driver's step-by-step tail); or
    the injected draws (idx_g [K, arch_every, 18], idx_r [K, arch_every,
    18], gumbel_u [K, 18, 8]).

    The generator's draws respect kw's valid_mask, as the steps do.

    steps: the SearchStepFns to run (default: make_search_steps(net, **kw);
    capture=True there replays each step from its graph on the card). The
    units are a host loop over those steps: on the card it enqueues
    replays and draws without waiting for the card, so K > 1 saves no
    dispatch, unlike the JAX package's scan over a remote device."""
    if steps is None:
        steps = make_search_steps(net, num_classes=num_classes, **kw)
    valid = kw.get("valid_mask")

    def run(params, mom, arch_params, opt_a, masks, update_masks, xw, yw, xa,
            ya, lr, T, lat_vec, base_lat, draws):
        gen = draws if isinstance(draws, torch.Generator) else None
        num_ops = arch_params["log_alphas"].shape[-1]
        wmet, amet = [], []
        for u in range(xw.shape[0]):
            for j in range(arch_every):
                if gen is not None:
                    ig = sample_gumbel_indices(arch_params["log_alphas"],
                                               gen, valid)
                    ir = sample_random_excluding(ig, num_ops, gen, valid)
                else:
                    ig, ir = draws[0][u, j], draws[1][u, j]
                params, mom, m = steps.weight_step(
                    params, arch_params, mom, masks, update_masks, xw[u, j],
                    yw[u, j], lr, ig, ir)
                # a captured step's metrics are overwritten by its next replay
                wmet.append({k: v.clone() for k, v in m.items()}
                            | {"idx_g": ig, "idx_r": ir})
            gu = (gumbel_uniform(arch_params["log_alphas"].shape, gen)
                  if gen is not None else draws[2][u])
            arch_params, opt_a, ma = steps.arch_step(
                params, arch_params, opt_a, masks, xa[u], ya[u], lat_vec,
                base_lat, T, gu)
            amet.append({k: v.clone() for k, v in ma.items()}
                        | {"gumbel_u": gu})
        n = xw.shape[0]
        wm = {k: torch.stack([m[k] for m in wmet]).reshape(
            n, arch_every, *wmet[0][k].shape) for k in wmet[0]}
        am = {k: torch.stack([m[k] for m in amet]) for k in amet[0]}
        return params, mom, arch_params, opt_a, wm, am

    return run


def cosine_lr_list(base_lr, epochs):
    """Per-epoch cosine lr (CosineAnnealingLR's closed form)."""
    return [base_lr * (1 + math.cos(math.pi * e / epochs)) / 2
            for e in range(epochs)]
