"""The search's random draws, from a torch.Generator: a frozen copy of the
port's sampler (every block offers every op). Given a generator in the
same state, the same calls in the same order give the same values, so
the reference makes the draws the program made from the same seed."""

from __future__ import annotations

import torch


def gumbel_pick(log_alphas, generator):
    """One categorical draw of softmax(log_alphas) per block, as
    argmax(p / q) with q ~ Exp(1). [B, O] -> int64 [B]."""
    probs = torch.softmax(log_alphas.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / q).argmax(dim=-1)


def partner(excluded, num_ops, generator):
    """Uniform over the ops of each block other than `excluded`."""
    r = torch.randint(0, num_ops - 1, excluded.shape, generator=generator,
                      device=excluded.device)
    return r + (r >= excluded).to(r.dtype)


def uniform(shape, generator):
    """The U in [1e-10, 1) of the arch step's Gumbel noise."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (1.0 - 1e-10) + 1e-10
