"""Gumbel and bi-sampling draws (counterpart of tfnas_tpu/search/bisample.py).

Every draw takes an explicit `torch.Generator` on the device of the logits,
so it runs on the card without a host sync. `torch.Generator` and
`jax.random` give different numbers from the same seed: the two packages
agree in distribution, and the step functions take the drawn values as
arguments so that tests can feed both the same draws.
"""

from __future__ import annotations

import torch


def _mask_logits(logits, valid):
    """-inf at the candidate slots a block does not offer (valid: 0/1
    [B, O], or None for a space where every block offers every op)."""
    if valid is None:
        return logits
    return torch.where(valid > 0, logits, float("-inf"))


def _categorical(logits, generator):
    """One draw of softmax(logits) per row as argmax(p / q), q ~ Exp(1):
    the draw torch.multinomial(p, 1) makes from the same generator state,
    without its check of p, which reads a device value on the host and so
    waits for the card. Slots of probability 0 are never drawn."""
    probs = torch.softmax(logits.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / q).argmax(dim=-1)


def sample_gumbel_indices(log_alphas, generator, valid=None):
    """One categorical draw of softmax(log_alphas) per block over its valid
    slots (the hard 'gumbel' pick). log_alphas: [B, O] -> int64 [B]."""
    return _categorical(_mask_logits(log_alphas, valid), generator)


def sample_random_excluding(excluded, num_ops, generator, valid=None):
    """Uniform draw over the candidates of each block minus `excluded` (the
    bi-sampling partner of the gumbel pick). excluded: int [B].

    With valid=None: a draw over {0..num_ops-1} shifted past `excluded`.
    With a validity mask [B, O]: argmax(p / q) with p uniform over
    valid \\ {excluded}, so an invalid slot is never drawn."""
    if valid is None:
        r = torch.randint(0, num_ops - 1, excluded.shape,
                          generator=generator, device=excluded.device)
        return r + (r >= excluded).to(r.dtype)
    allowed = (valid > 0) & ~torch.nn.functional.one_hot(
        excluded.long(), valid.shape[-1]).bool()
    q = torch.empty(allowed.shape, device=valid.device).exponential_(
        1.0, generator=generator)
    return (allowed.float() / q).argmax(dim=-1)


def sample_gumbel_excluding(log_alphas, excluded, generator):
    """The 'gumbel_2' draw: a categorical draw of softmax(log_alphas) with
    the paired gumbel pick `excluded` switched off. The temperature of the
    reference's form only rescales the softmax, so the hard pick does not
    depend on it. log_alphas: [B, O]; excluded: int [B] -> int64 [B]."""
    masked = torch.where(torch.nn.functional.one_hot(
        excluded.long(), log_alphas.shape[-1]).bool(), float("-inf"), log_alphas)
    return _categorical(masked, generator)


def sample_min_alphas(log_alphas):
    """The 'min_alphas' pick: argmin per block."""
    return log_alphas.argmin(dim=-1)


def sample_max_alphas(log_alphas):
    """The 'max_alphas' pick: argmax per block."""
    return log_alphas.argmax(dim=-1)


def gumbel_uniform(shape, generator):
    """The uniform draw U in [1e-10, 1) that Gumbel noise is made from."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (1.0 - 1e-10) + 1e-10


def gumbel_softmax_weights(log_alphas, temperature, u, valid=None):
    """softmax((log_alphas + g) / T) with g = -log(-log(u + 1e-10)), the
    soft weights of the arch step. [B, O] -> [B, O]. Invalid slots get
    exactly zero weight, and so zero gradient."""
    g = -torch.log(-torch.log(u + 1e-10))
    return torch.softmax(_mask_logits((log_alphas + g) / temperature, valid),
                         dim=-1)


def project_log_softmax(log_alphas, valid=None, sentinel=-30.0):
    """The post-arch-step projection log_alphas <- log_softmax(log_alphas),
    restricted to valid slots (a 0/1 [B, O] mask); invalid slots are pinned
    to a finite sentinel."""
    if valid is None:
        return torch.log_softmax(log_alphas, dim=-1)
    proj = torch.log_softmax(_mask_logits(log_alphas, valid), dim=-1)
    return torch.where(valid > 0, proj, sentinel)
