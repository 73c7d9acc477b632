"""The ViT block of the hybrid conv/ViT space (counterpart of
tfnas_tpu/ops/attention.py).

A pre-norm transformer block that can stand at any TF-NAS block site:
a patch merge (stride x stride average pool, then a 1x1 linear ic -> oc)
when stride > 1 or ic != oc, then x + MHSA(LN(x)) and x + MLP(LN(x)) over
the H*W tokens. The searchable width is the MLP hidden width, masked by a
0/1 `channel_mask` as the MBConv mid channels are: masked hidden units give
exactly zero activations and zero gradients.

The attention is written as the JAX package writes it, in plain matrix
products: q.k^T in the activation dtype, divided by sqrt(d) rounded to that
dtype, the softmax in f32 and cast back, then attn.v. A fused attention
kernel would skip the rounding of the logits, and its backward may
accumulate with atomics, which a CUDA-graph replay that must equal the
eager step bit for bit cannot have.

Activations are NCHW outside the block, as everywhere in the port; inside,
the tokens are [N, H*W, C] in row-major (h, w) order, the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .activations import apply_act
from .conv import init_linear, linear
from .layers import drop_connect

LN_EPS = 1e-6


def layer_norm(x, params, *, affine, eps=LN_EPS):
    """LayerNorm over the last axis, in f32. params: {} when affine=False,
    else {'gamma': [C], 'beta': [C]}."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if affine:
        y = y * params["gamma"].float() + params["beta"].float()
    return y.to(x.dtype)


def init_layer_norm(c, affine, device):
    if not affine:
        return {}
    return {"gamma": torch.ones((c,), device=device),
            "beta": torch.zeros((c,), device=device)}


def _rounded_sqrt(d, dtype):
    """sqrt(d) computed in f32 and rounded to `dtype`, as a Python float."""
    return float(torch.tensor(float(d)).sqrt().to(dtype))


def multi_head_attention(tokens, qkv_p, out_p, num_heads):
    """tokens [N, T, C] -> [N, T, C]; qkv_p, out_p: linear parameters."""
    n, t, c = tokens.shape
    d = c // num_heads
    qkv = linear(tokens, qkv_p).reshape(n, t, 3, num_heads, d)
    q = qkv[:, :, 0].transpose(1, 2)                 # [N, h, T, d]
    k = qkv[:, :, 1].permute(0, 2, 3, 1)             # [N, h, d, T]
    v = qkv[:, :, 2].transpose(1, 2)                 # [N, h, T, d]
    logits = torch.matmul(q, k) / _rounded_sqrt(d, tokens.dtype)
    attn = torch.softmax(logits.float(), dim=-1).to(tokens.dtype)
    o = torch.matmul(attn, v).transpose(1, 2).reshape(n, t, c)
    return linear(o, out_p)


@dataclasses.dataclass(frozen=True)
class ViTBlock:
    """Pre-norm transformer block as a TF-NAS candidate op."""

    in_channels: int
    mid_channels: int          # MLP hidden width (searchable)
    out_channels: int
    num_heads: int = 4
    stride: int = 1
    affine: bool = True        # LN affine (False during the search)
    act_func: Optional[str] = "swish"
    drop_connect_rate: float = 0.0

    name = "ViTBlock"
    # both branches add back their input: the drop-connect draws of a
    # block are a pair, one per branch
    has_residual = True

    @property
    def has_patch_merge(self):
        return self.stride > 1 or self.in_channels != self.out_channels

    @property
    def config(self):
        return {
            "name": "ViTBlock",
            "in_channels": self.in_channels,
            "mid_channels": self.mid_channels,
            "out_channels": self.out_channels,
            "num_heads": self.num_heads,
            "stride": self.stride,
            "affine": self.affine,
            "act_func": self.act_func,
        }

    def init(self, generator):
        c, mc, dev = self.out_channels, self.mid_channels, generator.device
        params = {
            "ln1": init_layer_norm(c, self.affine, dev),
            "qkv": init_linear(c, 3 * c, generator),
            "attn_out": init_linear(c, c, generator),
            "ln2": init_layer_norm(c, self.affine, dev),
            "mlp_in": init_linear(c, mc, generator),
            "mlp_out": init_linear(mc, c, generator),
        }
        if self.has_patch_merge:
            params["patch_proj"] = init_linear(self.in_channels, c, generator)
        return params, {}

    def apply(self, params, state, x, *, training=False, keep=None,
              channel_mask=None, bn_group=None):
        """x: [N, ic, H, W] -> [N, oc, H/s, W/s]. keep: (attn, mlp), the two
        [N] drop-connect draws (used when training with a rate > 0).
        bn_group is accepted for the common layer interface and unused:
        LayerNorm normalises each token alone."""
        del bn_group
        n = x.shape[0]
        x = x.permute(0, 2, 3, 1)                         # NHWC view
        if self.has_patch_merge:
            if self.stride > 1:
                s = self.stride
                h2, w2 = x.shape[1] // s, x.shape[2] // s
                x = x[:, :h2 * s, :w2 * s].reshape(
                    n, h2, s, w2, s, x.shape[-1]).mean(dim=(2, 4))
            x = linear(x, params["patch_proj"])
        h, w, c = x.shape[1], x.shape[2], x.shape[3]
        tokens = x.reshape(n, h * w, c)
        drop = (self.drop_connect_rate > 0.0 and training
                and keep is not None)

        a = multi_head_attention(
            layer_norm(tokens, params["ln1"], affine=self.affine),
            params["qkv"], params["attn_out"], self.num_heads)
        if drop:
            a = drop_connect(a, keep[0], self.drop_connect_rate)
        tokens = tokens + a

        z = linear(layer_norm(tokens, params["ln2"], affine=self.affine),
                   params["mlp_in"])
        if channel_mask is not None:
            z = z * channel_mask.to(z.dtype)
        z = linear(apply_act(z, self.act_func), params["mlp_out"])
        if drop:
            z = drop_connect(z, keep[1], self.drop_connect_rate)
        tokens = tokens + z
        return tokens.reshape(n, h, w, c).permute(0, 3, 1, 2), dict(state)

