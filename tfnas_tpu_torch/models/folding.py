"""BatchNorm folding for inference (counterpart of
tfnas_tpu/models/folding.py).

At eval time BN is a per-channel affine map with fixed running statistics,
so it folds into the convolution before it:
    kernel' = kernel * (gamma * rsqrt(var + eps))[out]
    bias'   = beta - mean * gamma * rsqrt(var + eps)   (+ bias * scale)
The fold is computed in float64 and stored in float32, as the JAX package
computes it in numpy float64.

CoAtNet's pre-norm MBConv block (ops/layers.MBConvPreNorm) has a BN before
its first 1x1 convolution as well; it folds into that convolution's input
side (kernel * scale[in], bias + kernel . offset), which is exact for a
1x1 kernel without padding at any stride. Its transformer blocks pass
through unchanged (LayerNorm keeps no running statistics).

`fold_batchnorm(net, params, state)` returns (folded_net, folded_params):
the same EvalNetwork with use_bn=False / bias=True layers, and
`folded_net.apply(folded_params, {}, x)` computes the eval-mode function.
`fold_stem_space_to_depth` then rewrites the folded 3x3 stride-2 stem as a
space-to-depth repack and a 2x2 stride-1 convolution over 4x the channels.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.activations import apply_act
from ..ops.attention import RelTransformerBlock, ViTBlock
from ..ops.batchnorm import BN_EPS
from ..ops.layers import ConvLayer, MBConvPreNorm
from .eval_net import EvalNetwork


def _fold_conv(conv_params, bn_params, bn_state, eps=BN_EPS):
    """{'kernel', 'bias'} of an OIHW conv with its BN folded in."""
    f64 = torch.float64
    scale = bn_params["scale"].to(f64) / torch.sqrt(
        bn_state["var"].to(f64) + eps)
    bias = bn_params["bias"].to(f64) - bn_state["mean"].to(f64) * scale
    if "bias" in conv_params:
        bias = bias + conv_params["bias"].to(f64) * scale
    kernel = conv_params["kernel"].to(f64) * scale[:, None, None, None]
    return {"kernel": kernel.float(), "bias": bias.float()}


def _fold_conv_layer(layer, params, state):
    if not layer.use_bn:
        return layer, dict(params)
    if layer.bn_before_weight:
        raise ValueError("only weight_bn_* orders fold")
    return (dataclasses.replace(layer, use_bn=False, bias=True),
            {"conv": _fold_conv(params["conv"], params["bn"], state["bn"])})


def _fold_input_bn(conv_params, bn_params, bn_state, eps=BN_EPS):
    """{'kernel', 'bias'} of a 1x1 OIHW conv without padding that follows
    a BN: the BN's per-channel scale and offset folded into its input
    side."""
    f64 = torch.float64
    scale = bn_params["scale"].to(f64) / torch.sqrt(
        bn_state["var"].to(f64) + eps)
    offset = bn_params["bias"].to(f64) - bn_state["mean"].to(f64) * scale
    kernel = conv_params["kernel"].to(f64)
    bias = kernel[:, :, 0, 0] @ offset
    if "bias" in conv_params:
        bias = bias + conv_params["bias"].to(f64)
    return {"kernel": kernel * scale[None, :, None, None], "bias": bias}


def _fold_prenorm(layer, params, state):
    if not layer.use_bn:
        return layer, dict(params)
    first = _fold_input_bn(params["inverted_bottleneck"]["conv"],
                           params["pre_norm"]["bn"], state["pre_norm"]["bn"])
    new_params = {
        "inverted_bottleneck": {"conv": _fold_conv(
            first, params["inverted_bottleneck"]["bn"],
            state["inverted_bottleneck"]["bn"])},
        "depth_conv": {"conv": _fold_conv(
            params["depth_conv"]["conv"], params["depth_conv"]["bn"],
            state["depth_conv"]["bn"])},
        "squeeze_excite": params["squeeze_excite"],
    }
    for sub in ("point_linear", "shortcut"):
        if sub in params:
            conv = params[sub]["conv"]
            new_params[sub] = {"conv": {
                "kernel": conv["kernel"],
                "bias": torch.zeros(conv["kernel"].shape[0],
                                    device=conv["kernel"].device)}}
    return dataclasses.replace(layer, use_bn=False), new_params


def _fold_mbconv(layer, params, state):
    if isinstance(layer, (ViTBlock, RelTransformerBlock)):
        # LayerNorm keeps no running statistics, so nothing folds; the
        # block passes through unchanged
        return layer, dict(params)
    if isinstance(layer, ConvLayer):
        return _fold_conv_layer(layer, params, state)
    if isinstance(layer, MBConvPreNorm):
        return _fold_prenorm(layer, params, state)
    if not layer.use_bn:
        return layer, dict(params)
    new_params = {}
    for sub in ("inverted_bottleneck", "depth_conv", "point_linear"):
        if sub in params:
            new_params[sub] = {"conv": _fold_conv(
                params[sub]["conv"], params[sub]["bn"], state[sub]["bn"])}
    if "squeeze_excite" in params:
        new_params["squeeze_excite"] = params["squeeze_excite"]
    return dataclasses.replace(layer, use_bn=False, bias=True), new_params


def fold_batchnorm(net: EvalNetwork, params, state):
    """(folded_net, folded_params): the eval-mode function with every BN
    folded into a convolution's bias."""
    fs_layer, fs_params = _fold_conv_layer(
        net.first_stem, params["first_stem"], state["first_stem"])
    ss_layer, ss_params = _fold_mbconv(
        net.second_stem, params["second_stem"], state["second_stem"])
    new_params = {"first_stem": fs_params, "second_stem": ss_params}
    stages = OrderedDict()
    for stage, blocks in net.stages.items():
        out_blocks, sp = [], {}
        for i, block in enumerate(blocks):
            bn = f"block{i + 1}"
            nb, sp[bn] = _fold_mbconv(block, params[stage][bn],
                                      state[stage][bn])
            out_blocks.append(nb)
        stages[stage] = out_blocks
        new_params[stage] = sp
    fm_layer = None
    if net.feature_mix_layer is not None:
        fm_layer, new_params["feature_mix_layer"] = _fold_conv_layer(
            net.feature_mix_layer, params["feature_mix_layer"],
            state["feature_mix_layer"])
    new_params["classifier"] = params["classifier"]
    folded = EvalNetwork(
        first_stem=fs_layer, second_stem=ss_layer, stages=stages,
        feature_mix_layer=fm_layer, classifier=net.classifier,
        dropout_rate=0.0, drop_connect_rate=0.0)
    return folded, new_params


@dataclasses.dataclass(frozen=True)
class SpaceToDepthStem:
    """The folded 3x3 stride-2 first conv as space-to-depth by 2 and an
    equivalent 2x2 stride-1 conv over 4x the channels, padded by one at
    the top and left. Output row i of the original conv reads input rows
    2i-1..2i+1, which lie in s2d rows i-1 and i; taps outside the 3x3
    kernel get zero weights. Input channel (a * 2 + b) * C + c of the 2x2
    conv is channel c at offset (a, b) of its 2x2 block."""

    in_channels: int          # the original input channels (e.g. 3)
    out_channels: int
    act_func: Optional[str] = "relu6"
    stride: int = 2           # the original geometry, for resolutions

    name = "SpaceToDepthStem"

    def apply(self, params, state, x, *, training=False, bn_group=None):
        del training, bn_group  # no BN: it is folded in
        n, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError("the s2d stem needs even input sizes")
        # repacked in NHWC order, x's memory order on the card, so that the
        # conv's output, and every layer after it, stays channels_last
        x = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        x = F.pad(x, (0, 0, 1, 0, 1, 0)).permute(0, 3, 1, 2)
        y = F.conv2d(x, params["conv"]["kernel"].to(x.dtype),
                     params["conv"]["bias"].to(x.dtype))
        return apply_act(y, self.act_func), {}


def _s2d_stem_kernel(w):
    """OIHW [O, C, 3, 3] stride-2 kernel -> the [O, 4C, 2, 2] kernel of the
    s2d stem. Tap (u, v) at block offset (a, b) is original tap
    (2u + a - 1, 2v + b - 1); taps outside the 3x3 kernel stay zero."""
    cout, cin = w.shape[:2]
    wp = torch.zeros((cout, 4 * cin, 2, 2), dtype=torch.float32,
                     device=w.device)
    for u in range(2):
        for v in range(2):
            for a in range(2):
                for b in range(2):
                    di, dj = 2 * u + a - 1, 2 * v + b - 1
                    if 0 <= di < 3 and 0 <= dj < 3:
                        lo = (a * 2 + b) * cin
                        wp[:, lo:lo + cin, u, v] = w[:, :, di, dj]
    return wp


def fold_stem_space_to_depth(net: EvalNetwork, params):
    """Rewrite a BN-folded net's first stem as SpaceToDepthStem. Takes the
    output of fold_batchnorm (a BN-free ConvLayer stem with a bias, k 3,
    stride 2, groups 1) and returns (new_net, new_params)."""
    layer = net.first_stem
    if not (isinstance(layer, ConvLayer) and not layer.use_bn
            and layer.bias):
        raise ValueError("fold_batchnorm first: the s2d fold takes the "
                         "folded ConvLayer stem")
    if (layer.kernel_size, layer.stride, layer.groups) != (3, 2, 1):
        raise ValueError("the s2d fold is specific to the 3x3 stride-2 stem")
    kernel = params["first_stem"]["conv"]["kernel"]
    new_layer = SpaceToDepthStem(in_channels=kernel.shape[1],
                                 out_channels=layer.out_channels,
                                 act_func=layer.act_func)
    new_params = dict(params)
    new_params["first_stem"] = {"conv": {
        "kernel": _s2d_stem_kernel(kernel),
        "bias": params["first_stem"]["conv"]["bias"].float()}}
    new_net = EvalNetwork(
        first_stem=new_layer, second_stem=net.second_stem, stages=net.stages,
        feature_mix_layer=net.feature_mix_layer, classifier=net.classifier,
        dropout_rate=0.0, drop_connect_rate=0.0)
    return new_net, new_params
