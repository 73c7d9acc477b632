"""Loss and accuracy metrics (counterpart of tfnas_tpu/utils/metrics.py)."""

from __future__ import annotations

import torch


def accuracy(logits, targets, topk=(1,), weights=None):
    """Top-k accuracy in percent, a list of 0-dim tensors. weights: optional
    [N] 0/1 mask of valid samples for padded batches."""
    pred = torch.topk(logits, max(topk), dim=-1).indices
    correct = (pred == targets[:, None]).float()
    if weights is not None:
        w = weights.float()
        correct = correct * w[:, None]
        n = torch.clamp(w.sum(), min=1.0)
    else:
        n = targets.shape[0]
    return [correct[:, :k].sum() * (100.0 / n) for k in topk]


def masked_mean(values, weights):
    """Mean of per-sample values over a 0/1 validity mask."""
    w = weights.float()
    return (values * w).sum() / torch.clamp(w.sum(), min=1.0)


def nll(logits, targets):
    """Per-sample negative log-likelihood in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[:, None].long())[:, 0]


def cross_entropy(logits, targets):
    return nll(logits, targets).mean()


def cross_entropy_label_smooth(logits, targets, num_classes, epsilon=0.1):
    """Label-smoothed CE: sum over classes of the batch mean of
    -((1 - eps) * onehot + eps / num_classes) * log_softmax, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(targets.long(), num_classes).float()
    smooth = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-smooth * logp).mean(dim=0).sum()
