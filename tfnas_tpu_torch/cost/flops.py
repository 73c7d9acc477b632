"""Analytic FLOPs and parameter counts (the port's own copy of
tfnas_tpu/cost/flops.py).

A static walk over the layer objects; multiply-accumulates are counted
once, as the reference's forward hooks count them:

- Conv2d: k_h * k_w * cin * cout / groups * oh * ow (+ cout * oh * ow with
  a bias);
- Linear: in * out (+ out with a bias);
- AdaptiveAvgPool2d(1): C * h * w;
- the SE convolutions are 1x1 convolutions with a bias on a 1x1 map;
- a ViT block: the patch-merge projection, QKV, q.k^T and attn.v, the
  attention's out projection and the two MLP linears;
- CoAtNet's pre-norm MBConv block: its 1x1 convolutions at the output
  resolution (the stride is in the first), the depthwise convolution, the
  SE pool and linears, and the 1x1 shortcut projection when ic != oc (BN
  and the max pool count nothing);
- CoAtNet's transformer block: the shortcut linear, QKV from ic,
  q.k^T and attn.v, the out projection and the two feed-forward linears
  (the relative bias is an addition and counts nothing).

`count_parameters_in_MB` counts parameters / 1e6 (BN running statistics
are state, not parameters).
"""

from __future__ import annotations

from ..ops.attention import RelTransformerBlock, ViTBlock
from ..ops.layers import (ConvLayer, IdentityLayer, LinearLayer,
                          MBConvPreNorm, MBInvertedResBlock)
from ..search.train_step import tree_leaves


def count_parameters_in_MB(params):
    """Total number of parameters / 1e6."""
    return sum(int(l.numel()) for l in tree_leaves(params)) / 1e6


def _conv_flops(k, cin, cout, groups, oh, ow, bias):
    f = k * k * cin * cout / groups * oh * ow
    if bias:
        f += cout * oh * ow
    return f


def _out_res(res, stride, k):
    # symmetric k // 2 padding
    return (res + 2 * (k // 2) - k) // stride + 1


def layer_flops(layer, in_res):
    """(flops, out_res) of one layer at square input resolution in_res."""
    if isinstance(layer, ConvLayer):
        out_res = _out_res(in_res, layer.stride, layer.kernel_size)
        f = _conv_flops(layer.kernel_size, layer.in_channels,
                        layer.out_channels, layer.groups, out_res, out_res,
                        layer.bias)
        return f, out_res
    if isinstance(layer, IdentityLayer):
        return 0.0, in_res
    if isinstance(layer, LinearLayer):
        f = layer.in_features * layer.out_features
        if layer.bias:
            f += layer.out_features
        return f, in_res
    if isinstance(layer, MBInvertedResBlock):
        mc = layer.mid_channels
        f = 0.0
        res = in_res
        if layer.has_expand:
            f += _conv_flops(1, layer.in_channels, mc, layer.groups, res, res,
                             layer.bias)
        out_res = _out_res(res, layer.stride, layer.kernel_size)
        # depthwise: in = out = groups = mc
        f += _conv_flops(layer.kernel_size, mc, mc, mc, out_res, out_res,
                         layer.bias)
        if layer.has_se:
            f += mc * out_res * out_res  # the global average pool
            f += _conv_flops(1, mc, layer.se_channels, layer.groups, 1, 1, True)
            f += _conv_flops(1, layer.se_channels, mc, layer.groups, 1, 1, True)
        f += _conv_flops(1, mc, layer.out_channels, layer.groups,
                         out_res, out_res, layer.bias)
        return f, out_res
    if isinstance(layer, ViTBlock):
        c, mc = layer.out_channels, layer.mid_channels
        out_res = in_res // layer.stride if layer.stride > 1 else in_res
        t = out_res * out_res
        f = 0.0
        if layer.has_patch_merge:
            f += t * (layer.in_channels * c + c)         # 1x1 proj + bias
        f += t * (3 * c * c + 3 * c)                     # QKV
        f += 2.0 * t * t * c                             # q.k^T and attn.v
        f += t * (c * c + c)                             # attn out proj
        f += t * (c * mc + mc)                           # mlp in
        f += t * (mc * c + c)                            # mlp out
        return f, out_res
    if isinstance(layer, MBConvPreNorm):
        ic, mc, oc = layer.in_channels, layer.mid_channels, layer.out_channels
        o = in_res // layer.stride
        bias = not layer.use_bn
        f = _conv_flops(1, ic, mc, 1, o, o, bias)
        f += _conv_flops(layer.kernel_size, mc, mc, mc, o, o, bias)
        f += mc * o * o  # the SE pool
        f += _conv_flops(1, mc, layer.se_channels, 1, 1, 1, True)
        f += _conv_flops(1, layer.se_channels, mc, 1, 1, 1, True)
        f += _conv_flops(1, mc, oc, 1, o, o, bias)
        if layer.has_proj:
            f += _conv_flops(1, ic, oc, 1, o, o, bias)
        return f, o
    if isinstance(layer, RelTransformerBlock):
        ic, mc, c = layer.in_channels, layer.mid_channels, layer.out_channels
        o = in_res // layer.stride
        t = o * o
        f = 0.0
        if layer.has_proj:
            f += t * (ic * c + c)                        # shortcut linear
        f += t * (3 * ic * c + 3 * c)                    # QKV
        f += 2.0 * t * t * c                             # q.k^T and attn.v
        f += t * (c * c + c)                             # attn out proj
        f += t * (c * mc + mc)                           # mlp in
        f += t * (mc * c + c)                            # mlp out
        return f, o
    raise TypeError(f"unknown layer type: {type(layer)}")


def calculate_FLOPs_in_M(network, input_size=224):
    """Whole-network FLOPs in millions of an EvalNetwork."""
    total = 0.0
    res = input_size
    for layer in [network.first_stem, network.second_stem]:
        f, res = layer_flops(layer, res)
        total += f
    for _, _, block in network.iter_blocks():
        f, res = layer_flops(block, res)
        total += f
    if network.feature_mix_layer is not None:
        f, res = layer_flops(network.feature_mix_layer, res)
        total += f
    total += network.classifier.in_features * res * res  # the pool
    f, _ = layer_flops(network.classifier, 1)
    total += f
    return total / 1e6
