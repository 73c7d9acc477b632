"""JAX parameter trees <-> the port's tensors.

The JAX package keeps convolution kernels HWIO ([kh, kw, I, O]) and the
supernet's stacked candidates as [8, kh, kw, I, O]; the port keeps them OIHW
([O, I, kh, kw]) and [8, O, I, kh, kw]. In both trees the 4-d and 5-d leaves
are exactly the convolution kernels, so the rank decides the layout; every
other leaf (dense and SE kernels, biases, BN statistics, arch parameters,
masks, and the whole `vit` subtree of the hybrid space: [in, out] linear
kernels, biases, LayerNorm parameters) is copied as it is. Keys and nesting are the same in both trees, so
the same two functions carry eval-network parameters, BN state and
momentum (the folded stem's [2, 2, 4C, O] kernel included) both ways.

The JAX Pareto search stacks its G groups' trees into one tree of [G, ...]
leaves; the port keeps one tree per group. `stack_group_trees` and
`unstack_group_tree` go between the two (numpy leaves, per-group trees in
either package's layout: convert each group's tree on its own).
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.train_dp import EvalTrainState
from .search.train_step import zeros_like_tree

_TO_TORCH = {4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}
_TO_JAX = {4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def stack_group_trees(trees):
    """[tree_g for g in G] -> one tree of [G, ...] numpy leaves."""
    if isinstance(trees[0], dict):
        return {k: stack_group_trees([t[k] for t in trees])
                for k in trees[0]}
    return np.stack([_host(t) for t in trees])


def unstack_group_tree(tree):
    """One tree of [G, ...] leaves -> [tree_g for g in G] (numpy)."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_map(tree, lambda a, g=g: _host(a)[g]) for g in range(len(first))]


def params_from_jax(tree, device="cpu"):
    """numpy (or JAX) parameter tree -> f32 tensors in the port's layout."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        if a.ndim in _TO_TORCH:
            a = np.transpose(a, _TO_TORCH[a.ndim])
        return torch.tensor(np.ascontiguousarray(a), device=device)
    return _map(tree, leaf)


def params_to_jax(tree):
    """The port's parameter tree -> numpy arrays in the JAX layout."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        if a.ndim in _TO_JAX:
            a = np.ascontiguousarray(np.transpose(a, _TO_JAX[a.ndim]))
        return a
    return _map(tree, leaf)


def arch_from_jax(tree, device="cpu"):
    """Arch parameters (no layout change) -> f32 tensors."""
    return _map(tree, lambda a: torch.tensor(np.asarray(a, np.float32),
                                             device=device))


def eval_state_from_jax(ckpt, device="cpu"):
    """An eval checkpoint's {'params', 'bn_state', 'momentum', 'epoch'}
    (either package's) -> EvalTrainState of tensors on `device`; a missing
    momentum starts at zero."""
    params = params_from_jax(ckpt["params"], device)
    mom = ckpt.get("momentum")
    return EvalTrainState(
        params, params_from_jax(ckpt["bn_state"], device),
        zeros_like_tree(params) if mom is None
        else params_from_jax(mom, device), int(ckpt.get("epoch", 0)))
