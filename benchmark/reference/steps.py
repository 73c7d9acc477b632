"""Plain PyTorch training steps of the reference: parameter trees, the
optimisers, the search's weight and arch steps and the retrain step.

A frozen copy of the port's step arithmetic, leaf by leaf:
- weights: clip by global norm -> g + wd * p -> momentum buffer ->
  p - lr * buf * update_mask;
- arch: Adam (L2 decay in the gradient) after the same clip, then
  log_softmax of log_alphas and of every stage's betas.
Steps are functional: they return new trees.
"""

from __future__ import annotations

import torch

from .nn import cross_entropy, cross_entropy_label_smooth


def leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def paths(tree, prefix=""):
    """'a/b/c' names of the leaves, in leaves() order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in paths(v, f"{prefix}{k}/")]
    return [] if tree is None else [prefix.rstrip("/")]


def value_and_grad(loss_fn, tree):
    """((loss, aux), grads) of loss_fn(tree) -> (loss, aux)."""
    ls = leaves(tree)
    it = iter([l.detach().requires_grad_() for l in ls])
    live = tree_map(lambda _: next(it), tree)
    loss, aux = loss_fn(live)
    lv = leaves(live)
    gs = torch.autograd.grad(loss, lv, allow_unused=True)
    gs = iter([torch.zeros_like(l) if g is None else g
               for l, g in zip(lv, gs)])
    return (loss.detach(), aux), tree_map(lambda _: next(gs), tree)


def clip(grads, max_norm):
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in leaves(grads)]))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def aligned(tree, like):
    """The entries of `tree` (None kept) at the leaves of `like`, in
    leaves(like) order."""
    if isinstance(like, dict):
        return [l for k, v in like.items()
                for l in aligned(None if tree is None else tree[k], v)]
    return [tree]


def unflatten(like, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def sgd_momentum(params, grads, mom, update_masks, *, lr, momentum,
                 weight_decay, grad_clip):
    grads = clip(grads, grad_clip)
    new_p, new_m = [], []
    for p, g, m, k in zip(leaves(params), aligned(grads, params),
                          aligned(mom, params),
                          aligned(update_masks, params)):
        m = m * momentum + (g + p * weight_decay)
        d = m * lr
        new_p.append(p - (d if k is None else d * k))
        new_m.append(m)
    return unflatten(params, new_p), unflatten(params, new_m)


def adam_init(params):
    z = tree_map(torch.zeros_like, params)
    return {"step": torch.zeros((), device=leaves(params)[0].device),
            "mu": z, "nu": tree_map(torch.zeros_like, params)}


def adam(params, grads, st, *, lr, b1, b2, eps, weight_decay, grad_clip):
    grads = clip(grads, grad_clip)
    g = tree_map(lambda g, p: g + p * weight_decay, grads, params)
    step = st["step"] + 1
    mu = tree_map(lambda m, g: m * b1 + g * (1 - b1), st["mu"], g)
    nu = tree_map(lambda v, g: v * b2 + g * (1 - b2) * g, st["nu"], g)
    bc1 = (1 - b1 ** step.double()).float()
    bc2 = (1 - b2 ** step.double()).float()
    new = tree_map(lambda p, m, v: p - (m / bc1 * lr)
                   / (torch.sqrt(v / bc2) + eps), params, mu, nu)
    return new, {"step": step, "mu": mu, "nu": nu}


def gumbel_softmax_weights(log_alphas, temperature, u):
    g = -torch.log(-torch.log(u + 1e-10))
    return torch.softmax((log_alphas + g) / temperature, dim=-1)


def weight_step(net, params, arch, mom, masks, update_masks, x, y, lr,
                idx_g, idx_r, *, hp):
    """The bi-sampling weight step: CE of both sampled paths, masked SGD."""
    def loss_fn(p):
        la, lb = net.apply_sampled_pair(p, arch, masks, x, idx_g, idx_r)
        return cross_entropy(la, y) + cross_entropy(lb, y), None
    (loss, _), grads = value_and_grad(loss_fn, params)
    params, mom = sgd_momentum(params, grads, mom, update_masks, lr=lr,
                               momentum=hp["w_mom"],
                               weight_decay=hp["w_wd"],
                               grad_clip=hp["grad_clip"])
    return params, mom, loss


def arch_step(net, params, arch, opt, masks, x, y, lat_vec, base_lat, T,
              u, *, hp):
    """The soft arch step: CE + the latency loss, Adam, the projection.
    Returns (arch, opt, the CE part of the loss)."""
    params = tree_map(torch.Tensor.detach, params)

    def loss_fn(a):
        w = gumbel_softmax_weights(a["log_alphas"], T, u)
        logits, lat = net.apply_soft(params, a, masks, x, w, lat_vec)
        lat = lat + base_lat
        dev = lat / hp["target_lat"] - 1.0
        loss_l = torch.where(dev < 0.0, -dev * hp["lat_under_boost"],
                             dev) * hp["lambda_lat"]
        loss_a = cross_entropy(logits, y)
        return loss_a + loss_l, loss_a.detach()
    (_, loss_a), grads = value_and_grad(loss_fn, arch)
    arch, opt = adam(arch, grads, opt, lr=hp["a_lr"], b1=hp["a_beta1"],
                     b2=hp["a_beta2"], eps=1e-8, weight_decay=hp["a_wd"],
                     grad_clip=hp["grad_clip"])
    arch = {"log_alphas": torch.log_softmax(arch["log_alphas"], dim=-1),
            "betas": {k: torch.log_softmax(v, dim=-1)
                      for k, v in arch["betas"].items()}}
    return arch, opt, loss_a


def retrain_step(net, params, bn_state, mom, x, y, lr, keep, *, hp):
    """The eval network's training step: label-smoothed CE, SGD momentum
    over every leaf. Returns (params, bn_state, mom, loss)."""
    def loss_fn(p):
        logits, new_bn = net.apply(p, bn_state, x, training=True, keep=keep)
        return cross_entropy_label_smooth(
            logits, y, net.num_classes, hp["label_smooth"]), new_bn
    (loss, new_bn), grads = value_and_grad(loss_fn, params)
    params, mom = sgd_momentum(params, grads, mom, None, lr=lr,
                               momentum=hp["momentum"],
                               weight_decay=hp["weight_decay"],
                               grad_clip=hp["grad_clip"])
    return params, tree_map(torch.Tensor.detach, new_bn), mom, loss
