"""Batch normalisation over the channel axis of NCHW (or NC) tensors
(counterpart of tfnas_tpu/ops/batchnorm.py).

`affine` and running statistics are tied as in the reference: search-time
BN (`affine=False`) keeps no running statistics and always normalises with
the batch moments. Statistics are taken in f32; the normalising variance is
biased, the running variance unbiased, momentum 0.1, eps 1e-5.

Cross-replica BN (the apex sync-BN of train_eval_amp.py:155-157):
with a process group, the batch moments are the mean over its ranks of
each rank's mean and E[x^2], through one differentiable all-reduce, and
the running variance's count is the global one.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum, group_size

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def stat_dtype(dtype):
    """f32 statistics for low-precision activations; float64 stays."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def init_bn(num_features, affine, device=None):
    """(params, state) of one BN; both empty when affine=False."""
    if not affine:
        return {}, {}
    params = {"scale": torch.ones(num_features, device=device),
              "bias": torch.zeros(num_features, device=device)}
    state = {"mean": torch.zeros(num_features, device=device),
             "var": torch.ones(num_features, device=device)}
    return params, state


def batch_norm(x, params, state, *, affine, training, group=None,
               momentum=BN_MOMENTUM, eps=BN_EPS):
    """Returns (y, new_state); `state` passes through unchanged when
    affine=False or when not training. group: the process group to take
    the batch moments over (None: this process's batch)."""
    reduce_dims = (0,) + tuple(range(2, x.dim()))
    sd = stat_dtype(x.dtype)
    if affine and not training:
        mean, var = state["mean"], state["var"]
        new_state = state
    else:
        xf = x.to(sd)
        mean = xf.mean(dim=reduce_dims)
        mean_sq = (xf * xf).mean(dim=reduce_dims)
        n = x.numel() // x.shape[1]
        if group is not None:
            world = group_size(group)
            mean, mean_sq = (all_reduce_sum(torch.cat([mean, mean_sq]),
                                            group) / world).chunk(2)
            n = n * world
        var = mean_sq - mean * mean  # biased
        if affine:
            unbiased = var * (n / max(n - 1.0, 1.0))
            new_state = {
                "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
                "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
            }
        else:
            new_state = state
    scale = torch.rsqrt(var.to(sd) + eps)
    offset = -mean.to(sd) * scale
    if affine:
        offset = offset * params["scale"].to(sd) + params["bias"].to(sd)
        scale = scale * params["scale"].to(sd)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.to(sd) * scale.view(shape) + offset.view(shape)).to(x.dtype)
    return y, new_state
