"""Convolution and linear primitives (counterpart of tfnas_tpu/ops/conv.py).

Activations are logical NCHW (in `channels_last` memory on the card) and
convolution kernels OIHW. Padding is the torch-symmetric `k // 2`. Dense
kernels keep the JAX package's `[in, out]` layout. Weights are f32 and are
cast to the activation dtype at use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def torch_uniform_init(shape, fan_in, generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): nn.Conv2d / nn.Linear's default,
    drawn from `generator` on its device."""
    bound = 1.0 / math.sqrt(float(fan_in)) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return u * (2.0 * bound) - bound


def init_conv_kernel(kh, kw, cin_per_group, cout, generator):
    """OIHW kernel, torch-default init (fan_in = kh * kw * cin_per_group)."""
    return torch_uniform_init((cout, cin_per_group, kh, kw),
                              kh * kw * cin_per_group, generator)


def init_linear(in_features, out_features, generator, bias=True):
    p = {"kernel": torch_uniform_init((in_features, out_features),
                                      in_features, generator)}
    if bias:
        p["bias"] = torch.zeros((out_features,), device=generator.device)
    return p


def conv2d(x, kernel, *, stride=1, groups=1, bias=None):
    """NCHW convolution with symmetric `k // 2` padding; the kernel is cast
    to x's dtype."""
    y = F.conv2d(x, kernel.to(x.dtype), None, stride, kernel.shape[-1] // 2,
                 1, groups)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y


def linear(x, params):
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def global_avg_pool(x):
    """NCHW -> NC global average pool."""
    return x.mean(dim=(2, 3))


def channel_shuffle(x, groups):
    """NCHW channel shuffle (tfnas_tpu/ops/conv.py `channel_shuffle`)."""
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)
