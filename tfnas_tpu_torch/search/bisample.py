"""Gumbel and bi-sampling draws (counterpart of tfnas_tpu/search/bisample.py).

Every draw takes an explicit `torch.Generator` on the device of the logits,
so it runs on the card without a host sync. `torch.Generator` and
`jax.random` give different numbers from the same seed: the two packages
agree in distribution, and the step functions take the drawn values as
arguments so that tests can feed both the same draws.
"""

from __future__ import annotations

import torch


def sample_gumbel_indices(log_alphas, generator):
    """One categorical draw of softmax(log_alphas) per block (the hard
    'gumbel' pick). log_alphas: [B, O] -> int64 [B].

    argmax(p / q) with q ~ Exp(1) is the draw torch.multinomial(p, 1) makes
    from the same generator state, without its check of p, which reads a
    device value on the host and so waits for the card."""
    probs = torch.softmax(log_alphas.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / q).argmax(dim=-1)


def sample_random_excluding(excluded, num_ops, generator):
    """Uniform draw over {0..num_ops-1} minus `excluded` per block (the
    bi-sampling partner of the gumbel pick). excluded: int [B]."""
    r = torch.randint(0, num_ops - 1, excluded.shape, generator=generator,
                      device=excluded.device)
    return r + (r >= excluded).to(r.dtype)


def gumbel_uniform(shape, generator):
    """The uniform draw U in [1e-10, 1) that Gumbel noise is made from."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (1.0 - 1e-10) + 1e-10


def gumbel_softmax_weights(log_alphas, temperature, u):
    """softmax((log_alphas + g) / T) with g = -log(-log(u + 1e-10)), the
    soft weights of the arch step. [B, O] -> [B, O]."""
    g = -torch.log(-torch.log(u + 1e-10))
    return torch.softmax((log_alphas + g) / temperature, dim=-1)


def project_log_softmax(log_alphas, valid=None, sentinel=-30.0):
    """The post-arch-step projection log_alphas <- log_softmax(log_alphas),
    restricted to valid slots (a 0/1 [B, O] mask); invalid slots are pinned
    to a finite sentinel."""
    if valid is None:
        return torch.log_softmax(log_alphas, dim=-1)
    proj = torch.log_softmax(
        torch.where(valid > 0, log_alphas, float("-inf")), dim=-1)
    return torch.where(valid > 0, proj, sentinel)
