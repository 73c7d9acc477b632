"""Activation functions of the TF-NAS search space
(counterpart of tfnas_tpu/ops/activations.py), and CoAtNet's exact GELU,
which the JAX package does not have."""

from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def swish(x):
    return x * torch.sigmoid(x)


def hard_swish(x):
    return x * relu6(x + 3.0) * (1.0 / 6.0)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def gelu(x):
    """Exact GELU, x * Phi(x) through erf (CoAtNet's activation)."""
    return torch.nn.functional.gelu(x)


# act_func string -> callable; the names are part of the model.config JSON.
ACT_FNS = {
    "relu": relu,
    "relu6": relu6,
    "swish": swish,
    "h-swish": hard_swish,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "gelu": gelu,
}


def get_act_fn(act_func):
    """Activation callable for an act_func string; `None` means identity."""
    if act_func is None:
        return None
    if act_func not in ACT_FNS:
        raise ValueError(f"unsupported act_func: {act_func!r}")
    return ACT_FNS[act_func]


def apply_act(x, act_func):
    fn = get_act_fn(act_func)
    return x if fn is None else fn(x)
