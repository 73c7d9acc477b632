"""Plain PyTorch CoAtNet (arXiv:2106.04803), the reference of the CoAtNet
retrain cell: its layers written from the paper's equations as the cell's
configuration states them, the forward, the label-smoothed loss and the
SGD step. It imports nothing of the port: the primitives (convolution,
linear, batch norm, init draws, the loss, SGD) are those of nn.py and
steps.py. Float32 with TF32 off (`nn.strict_float32`).

The net is read from the port's model.config JSON (`model_config` makes
one): a stem of two 3x3 convolutions (`ConvLayer` entries), stages of
`MBConvPreNorm` then `RelTransformerBlock` entries, global pool and a
linear classifier. With w = the block's input, c -> c' its widths:

    MBConv:      sc = MaxPool2x2(w) [then Conv1x1 c -> c' when c != c']
                 h = GELU(BN1(Conv1x1_s(BN0(w), c -> m)))
                 h = GELU(BN2(DW3x3(h)));  h = h * SE(h)
                 y = sc + drop(Conv1x1(h, m -> c'))
    Transformer: sc = Linear(MaxPool2x2(w), c -> c') on a downsampling
                 block, else w;  a = RelAttn(MaxPool2x2(LN1(w)))
                 y = sc + drop(a);  y = y + drop(FFN(LN2(y)))
    RelAttn:     logits[n, i, j] = q_i . k_j / sqrt(d)
                                   + B_n[h_i - h_j + H - 1, w_i - w_j + W - 1]

The weights are drawn by `CoAtNet.init` from a Pool; the bias tables, the
LayerNorm affines and the SE biases are drawn away from the values a
fresh net starts at, so that a term left out reads otherwise than one
that is there.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import steps
from .nn import (apply_act, batch_norm, conv2d, init_bn, linear, rnd,
                 uniform_init)

LN_EPS = 1e-6


def gelu(x):
    return F.gelu(x)  # exact, through erf


def act(x, name):
    return gelu(x) if name == "gelu" else apply_act(x, name)


def layer_norm(x, p, eps=LN_EPS):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["gamma"] + p["beta"]


def max_pool(x, s):
    """NCHW s x s max pool at stride s (identity at 1)."""
    return x if s == 1 else F.max_pool2d(x, s, s)


def rel_index(h, w, device=None):
    """[T, T] flat indices into a (2h - 1, 2w - 1) table of the offset
    (h_i - h_j + h - 1, w_i - w_j + w - 1), tokens in row-major order."""
    rows = torch.arange(h * w, device=device) // w
    cols = torch.arange(h * w, device=device) % w
    dh = rows[:, None] - rows[None, :] + h - 1
    dw = cols[:, None] - cols[None, :] + w - 1
    return dh * (2 * w - 1) + dw


def drop(x, keep, rate):
    if keep is None or rate <= 0.0:
        return x
    return x / (1.0 - rate) * keep.to(x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 1))


def _linear_init(i, o, pool):
    return {"kernel": uniform_init((i, o), i, pool),
            "bias": torch.zeros(o, device=pool.device)}


def _ln_init(c, pool):
    """LayerNorm affine drawn around (1, 0)."""
    return {"gamma": 1.0 + uniform_init((c,), 4.0, pool),
            "beta": uniform_init((c,), 4.0, pool)}


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """Conv (+ BN) (+ act): the stem."""
    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    groups: int = 1
    has_shuffle: bool = False
    bias: bool = False
    use_bn: bool = True
    affine: bool = True
    act_func: Optional[str] = None
    ops_order: str = "weight_bn_act"
    drop_connect_rate: float = 0.0
    has_residual = False

    def init(self, pool):
        k, c = self.kernel_size, self.in_channels
        conv = {"kernel": uniform_init((self.out_channels, c, k, k),
                                       k * k * c, pool)}
        if self.bias:
            conv["bias"] = torch.zeros(self.out_channels, device=pool.device)
        params, state = {"conv": conv}, {}
        if self.use_bn:
            params["bn"], state["bn"] = init_bn(self.out_channels, True,
                                                pool.device)
        return params, state

    def apply(self, params, state, x, *, training=False, keep=None):
        x = conv2d(x, params["conv"]["kernel"], stride=self.stride,
                   bias=params["conv"].get("bias"))
        new_state = dict(state)
        if self.use_bn:
            x, new_state["bn"] = batch_norm(x, params["bn"], state["bn"],
                                            affine=True, training=training)
        return act(x, self.act_func), new_state


@dataclasses.dataclass(frozen=True)
class MBConvPreNorm:
    in_channels: int
    mid_channels: int
    se_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    use_bn: bool = True
    act_func: Optional[str] = "gelu"
    drop_connect_rate: float = 0.0
    has_residual = True

    def init(self, pool):
        c, m, o, k = (self.in_channels, self.mid_channels,
                      self.out_channels, self.kernel_size)
        se, dev = self.se_channels, pool.device

        def conv_bn(kernel):
            p, s = {"conv": {"kernel": kernel}}, {}
            p["bn"], s["bn"] = init_bn(kernel.shape[0], True, dev)
            return p, s

        params, state = {}, {}
        params["pre_norm"], state["pre_norm"] = {}, {}
        params["pre_norm"]["bn"], state["pre_norm"]["bn"] = init_bn(
            c, True, dev)
        params["inverted_bottleneck"], state["inverted_bottleneck"] = \
            conv_bn(uniform_init((m, c, 1, 1), c, pool))
        params["depth_conv"], state["depth_conv"] = conv_bn(
            uniform_init((m, 1, k, k), k * k, pool))
        params["squeeze_excite"] = {
            "conv_reduce": {"kernel": uniform_init((m, se), m, pool),
                            "bias": uniform_init((se,), m, pool)},
            "conv_expand": {"kernel": uniform_init((se, m), se, pool),
                            "bias": uniform_init((m,), se, pool)},
        }
        params["point_linear"] = {"conv": {
            "kernel": uniform_init((o, m, 1, 1), m, pool)}}
        if c != o:
            params["shortcut"] = {"conv": {
                "kernel": uniform_init((o, c, 1, 1), c, pool)}}
        return params, state

    def apply(self, params, state, x, *, training=False, keep=None):
        new = {k: dict(v) for k, v in state.items()}

        def bn(h, name):
            h, new[name]["bn"] = batch_norm(
                h, params[name]["bn"], state[name]["bn"], affine=True,
                training=training)
            return h

        sc = max_pool(x, self.stride)
        if "shortcut" in params:
            sc = conv2d(sc, params["shortcut"]["conv"]["kernel"])
        h = bn(x, "pre_norm")
        h = conv2d(h, params["inverted_bottleneck"]["conv"]["kernel"],
                   stride=self.stride)
        h = act(bn(h, "inverted_bottleneck"), self.act_func)
        h = conv2d(h, params["depth_conv"]["conv"]["kernel"],
                   groups=self.mid_channels)
        h = act(bn(h, "depth_conv"), self.act_func)
        se = params["squeeze_excite"]
        z = act(linear(h.mean(dim=(2, 3)), se["conv_reduce"]), self.act_func)
        h = h * torch.sigmoid(linear(z, se["conv_expand"]))[:, :, None, None]
        h = conv2d(h, params["point_linear"]["conv"]["kernel"])
        return sc + drop(h, keep, self.drop_connect_rate), new


@dataclasses.dataclass(frozen=True)
class RelTransformerBlock:
    in_channels: int
    mid_channels: int
    out_channels: int
    resolution: int
    head_dim: int = 32
    stride: int = 1
    act_func: Optional[str] = "gelu"
    drop_connect_rate: float = 0.0
    has_residual = True
    # a fault of the check's: "no_bias" leaves the bias out of the logits,
    # "transposed" indexes the table by j - i for i - j
    fault: Optional[str] = None

    @property
    def heads(self):
        return self.out_channels // self.head_dim

    def init(self, pool):
        c, o, m, r = (self.in_channels, self.out_channels,
                      self.mid_channels, self.resolution)
        params = {"ln1": _ln_init(c, pool)}
        if self.stride > 1 or c != o:
            params["shortcut"] = _linear_init(c, o, pool)
        params["qkv"] = _linear_init(c, 3 * o, pool)
        params["rel_bias"] = uniform_init(
            (self.heads, 2 * r - 1, 2 * r - 1), 1.0, pool)
        params["attn_out"] = _linear_init(o, o, pool)
        params["ln2"] = _ln_init(o, pool)
        params["mlp_in"] = _linear_init(o, m, pool)
        params["mlp_out"] = _linear_init(m, o, pool)
        return params, {}

    def attention(self, t, params, h, w):
        n, T, _ = t.shape
        hd, d = self.heads, self.head_dim
        qkv = linear(t, params["qkv"]).reshape(n, T, 3, hd, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        logits = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(d)
        idx = rel_index(h, w, t.device)
        if self.fault == "transposed":
            idx = idx.t()
        if self.fault != "no_bias":
            logits = logits + params["rel_bias"].reshape(hd, -1)[:, idx]
        attn = torch.softmax(logits, dim=-1)
        o = (rnd(attn) @ rnd(v)).transpose(1, 2).reshape(n, T, hd * d)
        return linear(o, params["attn_out"])

    def apply(self, params, state, x, *, training=False, keep=None):
        keep = keep if keep is not None else (None, None)
        n = x.shape[0]
        a = layer_norm(x.permute(0, 2, 3, 1), params["ln1"])
        a = max_pool(a.permute(0, 3, 1, 2), self.stride).permute(0, 2, 3, 1)
        h, w = a.shape[1], a.shape[2]
        sc = max_pool(x, self.stride).permute(0, 2, 3, 1)
        if "shortcut" in params:
            sc = linear(sc, params["shortcut"])
        t = sc.reshape(n, h * w, self.out_channels)
        a = self.attention(a.reshape(n, h * w, self.in_channels), params,
                           h, w)
        t = t + drop(a, keep[0], self.drop_connect_rate)
        z = linear(layer_norm(t, params["ln2"]), params["mlp_in"])
        z = linear(act(z, self.act_func), params["mlp_out"])
        t = t + drop(z, keep[1], self.drop_connect_rate)
        return t.reshape(n, h, w, self.out_channels).permute(0, 3, 1, 2), \
            dict(state)


@dataclasses.dataclass(frozen=True)
class Classifier:
    in_features: int
    out_features: int

    def init(self, pool):
        return {"linear": _linear_init(self.in_features, self.out_features,
                                       pool)}, {}


_LAYERS = {"ConvLayer": ConvLayer, "MBConvPreNorm": MBConvPreNorm,
           "RelTransformerBlock": RelTransformerBlock}


def layer_from_config(cfg, fault=None):
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name == "RelTransformerBlock" and fault:
        cfg["fault"] = fault
    return _LAYERS[name](**cfg)


def model_config(depths=(2, 2, 6, 14, 2), widths=(128, 128, 256, 512, 1024),
                 image_size=224, num_classes=1000, head_dim=32,
                 expand=4, mlp_ratio=4):
    """The model.config JSON of a CoAtNet of stage depths L and widths D
    (S0-S4: a conv stem of L[0] = 2 layers, two MBConv stages, two
    transformer stages), each stage's first block at stride 2."""
    assert depths[0] == 2, "the stem is two convolutions"
    stem = dict(name="ConvLayer", kernel_size=3, groups=1,
                has_shuffle=False, affine=True, ops_order="weight_bn_act")
    cfg = {
        "first_stem": dict(stem, stride=2, bias=False, in_channels=3,
                           out_channels=widths[0], use_bn=True,
                           act_func="gelu"),
        "second_stem": dict(stem, stride=1, bias=True,
                            in_channels=widths[0], out_channels=widths[0],
                            use_bn=False, act_func=None),
    }
    res, c = image_size // 2, widths[0]
    for s in range(1, 5):
        blocks, o = [], widths[s]
        res //= 2
        for i in range(depths[s]):
            ic = c if i == 0 else o
            stride = 2 if i == 0 else 1
            if s <= 2:
                blocks.append(dict(
                    name="MBConvPreNorm", in_channels=ic,
                    mid_channels=expand * o, se_channels=max(1, ic // 4),
                    out_channels=o, kernel_size=3, stride=stride,
                    use_bn=True, act_func="gelu"))
            else:
                blocks.append(dict(
                    name="RelTransformerBlock", in_channels=ic,
                    mid_channels=mlp_ratio * o, out_channels=o,
                    resolution=res, head_dim=head_dim, stride=stride,
                    act_func="gelu"))
        cfg[f"stage{s}"] = blocks
        c = o
    cfg["classifier"] = dict(name="LinearLayer", in_features=c,
                             out_features=num_classes, bias=True,
                             use_bn=False, affine=False, act_func=None,
                             ops_order="weight_bn_act")
    return cfg


class CoAtNet:
    """The net of a CoAtNet model.config. fault: a fault of the check's
    in every transformer block (RelTransformerBlock.fault)."""

    STAGES = ("stage1", "stage2", "stage3", "stage4")

    def __init__(self, model_config, num_classes, dropout_rate=0.0,
                 drop_connect_rate=0.0, fault=None):
        self.num_classes = num_classes
        self.first_stem = layer_from_config(model_config["first_stem"])
        self.second_stem = layer_from_config(model_config["second_stem"])
        self.names, blocks = [], []
        for st in self.STAGES:
            for i, c in enumerate(model_config.get(st, [])):
                self.names.append((st, f"block{i + 1}"))
                blocks.append(layer_from_config(c, fault))
        # the rate * idx / count schedule, the second stem counted first
        count = len(blocks) + 1
        self.blocks = [dataclasses.replace(
            b, drop_connect_rate=drop_connect_rate * (i + 2) / count)
            for i, b in enumerate(blocks)]
        self.classifier = Classifier(
            model_config["classifier"]["in_features"], num_classes)
        self.dropout_rate = dropout_rate

    def init(self, pool):
        """(params, bn_state) in the port's tree layout."""
        params, state = {}, {}
        for k in ("first_stem", "second_stem"):
            params[k], state[k] = getattr(self, k).init(pool)
        for (st, bk), b in zip(self.names, self.blocks):
            p, s = b.init(pool)
            params.setdefault(st, {})[bk] = p
            state.setdefault(st, {})[bk] = s
        params["classifier"], state["classifier"] = self.classifier.init(pool)
        return params, state

    def rel_bias_paths(self, paths):
        """Which of the leaf paths are relative-bias tables."""
        return [p.endswith("rel_bias") for p in paths]

    def draw_keep(self, n, generator):
        """The second stem's None, per block its [N] draw (a pair for a
        transformer block, one per branch), then the [N, features]
        dropout mask: the port's draw order."""
        dev = generator.device

        def one(rate):
            u = torch.rand((n,), generator=generator, device=dev)
            return torch.floor((1.0 - rate) + u)

        keep = [None]
        for b in self.blocks:
            r = b.drop_connect_rate
            if r <= 0.0:
                keep.append(None)
            elif isinstance(b, RelTransformerBlock):
                keep.append((one(r), one(r)))
            else:
                keep.append(one(r))
        if self.dropout_rate > 0.0:
            u = torch.rand((n, self.classifier.in_features),
                           generator=generator, device=dev)
            keep.append(u < 1.0 - self.dropout_rate)
        else:
            keep.append(None)
        return keep

    def apply(self, params, state, x, *, training=False, keep=None):
        """(logits, new_state) of [N, H, W, 3] x. Training recomputes each
        block's activations in the backward (the same function, a peak
        that fits)."""
        keep = keep if keep is not None else [None] * (len(self.blocks) + 2)
        new = {}
        x = x.permute(0, 3, 1, 2)
        for k in ("first_stem", "second_stem"):
            x, new[k] = getattr(self, k).apply(params[k], state[k], x,
                                               training=training)
        for i, ((st, bk), b) in enumerate(zip(self.names, self.blocks)):
            fn = functools.partial(b.apply, training=training,
                                   keep=keep[i + 1])
            p, s0 = params[st][bk], state[st][bk]
            if training:
                x, s = checkpoint(fn, p, s0, x, use_reentrant=False)
            else:
                x, s = fn(p, s0, x)
            new.setdefault(st, {})[bk] = s
        x = x.mean(dim=(2, 3))
        if self.dropout_rate > 0.0 and training and keep[-1] is not None:
            x = torch.where(keep[-1], x / (1.0 - self.dropout_rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        x = linear(x, params["classifier"]["linear"])
        new["classifier"] = {}
        return x, new


def retrain_step(net, params, bn_state, mom, x, y, lr, keep, *, hp):
    """Label-smoothed CE, then SGD momentum over every leaf (clip by the
    global norm, weight decay): steps.retrain_step on this net. Returns
    (params, bn_state, mom, loss)."""
    return steps.retrain_step(net, params, bn_state, mom, x, y, lr, keep,
                              hp=hp)
