"""The ViT block of the hybrid conv/ViT space (counterpart of
tfnas_tpu/ops/attention.py), and CoAtNet's transformer block with a
relative-position bias (`RelTransformerBlock`, which the JAX package does
not have).

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
import torch.nn.functional as F

from ..utils import trace
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



# -- CoAtNet (arXiv:2106.04803) ---------------------------------------------

def rel_index(h, w, device=None):
    """int64 [T, T], T = h * w: entry (i, j) is the flat index of the
    offset (h_i - h_j + h - 1, w_i - w_j + w - 1) in a (2h - 1, 2w - 1)
    table, tokens in row-major (h, w) order. Made on `device` by arange
    ops (no host copy, so it can be made inside a CUDA-graph capture)."""
    hh = torch.arange(h, device=device).repeat_interleave(w)
    ww = torch.arange(w, device=device).repeat(h)
    dh = hh[:, None] - hh[None, :] + (h - 1)
    dw = ww[:, None] - ww[None, :] + (w - 1)
    return dh * (2 * w - 1) + dw


def _diagonal_sums(g, n):
    """g [..., n, n] (indices i, j) -> [..., 2n - 1]: entry a is the sum of
    the g[i, j] with i - j = a - (n - 1). The columns are flipped, each row
    padded by n zeros and the rows read back n - 1 + ... wide, which puts
    g[i, j] in row i, column i + (n - 1 - j); summing the rows is then a
    plain reduction (no atomics)."""
    lead = g.shape[:-2]
    g = F.pad(g.flip(-1), (0, n))                      # [..., n, 2n]
    g = g.reshape(*lead, 2 * n * n)[..., :n * (2 * n - 1)]
    return g.reshape(*lead, n, 2 * n - 1).sum(dim=-2)


class _RelBias(torch.autograd.Function):
    """table [heads, 2h - 1, 2w - 1] -> bias [heads, T, T] by a gather.
    Its backward sums the incoming gradient over each offset's diagonals
    (`_diagonal_sums` over both axes) in place of the index-put with
    accumulation that plain indexing backs up through, which uses atomics
    on the card: a replayed train step must equal the eager one bit for
    bit."""

    @staticmethod
    def forward(ctx, table, h, w):
        ctx.hw = (h, w)
        heads = table.shape[0]
        idx = rel_index(h, w, table.device)
        return table.reshape(heads, -1)[:, idx]

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        heads = g.shape[0]
        g = g.reshape(heads, h, w, h, w).permute(0, 2, 4, 1, 3)
        g = _diagonal_sums(g, h)                        # [hd, w, w, 2h-1]
        g = _diagonal_sums(g.permute(0, 3, 1, 2), w)    # [hd, 2h-1, 2w-1]
        return g, None, None


def rel_bias(table, h, w):
    """The [heads, h*w, h*w] relative-position bias of an (h, w) grid."""
    return _RelBias.apply(table, h, w)


def rel_attention(tokens, params, num_heads, h, w):
    """tokens [N, T, ic] -> [N, T, oc]: q, k, v = Linear(tokens, ic ->
    3 oc) in heads of d = oc / num_heads; logits = q.k^T / sqrt(d) in the
    activation dtype, then + the relative bias in f32; the softmax in f32,
    cast back; out = Linear(softmax . v, oc -> oc)."""
    n, t, _ = tokens.shape
    qkv = linear(tokens, params["qkv"])
    c = qkv.shape[-1] // 3
    d = c // num_heads
    qkv = qkv.reshape(n, t, 3, num_heads, d)
    with trace.block_span("tfnas.attn.core"):
        q = qkv[:, :, 0].transpose(1, 2)                 # [N, h, T, d]
        k = qkv[:, :, 1].permute(0, 2, 3, 1)             # [N, h, d, T]
        v = qkv[:, :, 2].transpose(1, 2)                 # [N, h, T, d]
        logits = torch.matmul(q, k) / _rounded_sqrt(d, tokens.dtype)
        logits = logits.float() + rel_bias(params["rel_bias"], h, w)
        attn = torch.softmax(logits, dim=-1).to(tokens.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(n, t, c)
    return linear(o, params["attn_out"])


@dataclasses.dataclass(frozen=True)
class RelTransformerBlock:
    """CoAtNet's transformer block (arXiv:2106.04803 eqs. 3 and 5):

        a  = RelAttn(Pool(LN1(x)))     Pool: 2x2 max pool when stride > 1
        sc = Linear(Pool(x), ic -> oc) when stride > 1 or ic != oc, else x
        y  = sc + drop_connect(a)
        y  = y + drop_connect(Linear(act(Linear(LN2(y), oc -> mc)), mc -> oc))

    RelAttn has oc / head_dim heads and a learned (2r - 1) x (2r - 1) bias
    table per head, r the token grid's side (`resolution`, after the
    stride). Activations are NCHW outside the block; inside, tokens are
    [N, H*W, C] in row-major (h, w) order. LayerNorm keeps no running
    statistics, so the block folds to itself.
    """

    in_channels: int
    mid_channels: int          # the feed-forward's hidden width
    out_channels: int
    resolution: int            # the token grid's side after the stride
    head_dim: int = 32
    stride: int = 1
    act_func: Optional[str] = "gelu"
    drop_connect_rate: float = 0.0

    name = "RelTransformerBlock"
    # both branches add back their input: a pair of drop-connect draws
    has_residual = True

    @property
    def num_heads(self):
        return self.out_channels // self.head_dim

    @property
    def has_proj(self):
        return self.stride > 1 or self.in_channels != self.out_channels

    @property
    def config(self):
        return {
            "name": "RelTransformerBlock",
            "in_channels": self.in_channels,
            "mid_channels": self.mid_channels,
            "out_channels": self.out_channels,
            "resolution": self.resolution,
            "head_dim": self.head_dim,
            "stride": self.stride,
            "act_func": self.act_func,
        }

    def init(self, generator):
        ic, oc, mc, dev = (self.in_channels, self.out_channels,
                           self.mid_channels, generator.device)
        r = self.resolution
        params = {"ln1": init_layer_norm(ic, True, dev)}
        if self.has_proj:
            params["shortcut"] = init_linear(ic, oc, generator)
        params.update({
            "qkv": init_linear(ic, 3 * oc, generator),
            "rel_bias": torch.zeros((self.num_heads, 2 * r - 1, 2 * r - 1),
                                    device=dev),
            "attn_out": init_linear(oc, oc, generator),
            "ln2": init_layer_norm(oc, True, dev),
            "mlp_in": init_linear(oc, mc, generator),
            "mlp_out": init_linear(mc, oc, generator),
        })
        return params, {}

    def _pool(self, x):
        """NCHW max pool by the stride (identity at stride 1)."""
        if self.stride == 1:
            return x
        return F.max_pool2d(x, self.stride, self.stride)

    def apply(self, params, state, x, *, training=False, keep=None,
              bn_group=None):
        """x: [N, ic, H, W] -> [N, oc, H/s, W/s]. keep: (attn, mlp), the two
        [N] drop-connect draws (used when training with a rate > 0).
        bn_group is accepted for the common layer interface and unused."""
        del bn_group
        n = x.shape[0]
        a = layer_norm(x.permute(0, 2, 3, 1), params["ln1"], affine=True)
        a = self._pool(a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = a.shape[1], a.shape[2]
        if h != self.resolution or w != self.resolution:
            raise ValueError(
                f"a {h}x{w} token grid in a block whose bias tables are "
                f"made for {self.resolution}x{self.resolution}")
        sc = self._pool(x).permute(0, 2, 3, 1)          # NHWC view
        if self.has_proj:
            sc = linear(sc, params["shortcut"])
        tokens = sc.reshape(n, h * w, self.out_channels)
        a = rel_attention(a.reshape(n, h * w, self.in_channels), params,
                          self.num_heads, h, w)
        drop = (self.drop_connect_rate > 0.0 and training
                and keep is not None)
        if drop:
            a = drop_connect(a, keep[0], self.drop_connect_rate)
        tokens = tokens + a
        z = linear(layer_norm(tokens, params["ln2"], affine=True),
                   params["mlp_in"])
        z = linear(apply_act(z, self.act_func), params["mlp_out"])
        if drop:
            z = drop_connect(z, keep[1], self.drop_connect_rate)
        tokens = tokens + z
        return (tokens.reshape(n, h, w, self.out_channels)
                .permute(0, 3, 1, 2), dict(state))
