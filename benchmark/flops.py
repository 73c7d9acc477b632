"""Model FLOPs from shapes: a frozen copy of the port's cost/flops.py rules
(multiply-accumulates counted once, as the reference's forward hooks
count them) over the reference's layer objects, and the same rules over
the supernet's sampled and soft paths.

Rules:
- Conv2d: k * k * cin * cout / groups * oh * ow (+ cout * oh * ow with a
  bias); Linear: in * out (+ out with a bias); a global average pool:
  C * h * w; the SE convolutions: 1x1 convolutions with a bias on 1x1.
- A FLOP is 2 multiply-accumulates.
- A training step's backward that needs weight gradients costs twice its
  forward, one that needs only input gradients (the arch step: the
  weights are held) costs once: a weight step is 3x its forward, an arch
  step 2x.
- A sampled candidate counts at its live width (its mask's ones); the
  soft forward counts all 8 candidates of every block at their live
  widths.
"""

from __future__ import annotations

from .reference.nn import ConvLayer, LinearLayer, MBInvertedResBlock
from .reference.supernet import OP_KERNEL, OP_SE_MULT


def _conv(k, cin, cout, groups, oh, ow, bias):
    f = k * k * cin * cout / groups * oh * ow
    return f + (cout * oh * ow if bias else 0.0)


def _out_res(res, stride, k):
    return (res + 2 * (k // 2) - k) // stride + 1


def layer_macs(layer, res):
    """(multiply-accumulates, output resolution) of one layer."""
    if isinstance(layer, ConvLayer):
        o = _out_res(res, layer.stride, layer.kernel_size)
        return _conv(layer.kernel_size, layer.in_channels,
                     layer.out_channels, layer.groups, o, o,
                     layer.bias), o
    if isinstance(layer, LinearLayer):
        return (layer.in_features * layer.out_features
                + (layer.out_features if layer.bias else 0)), res
    if isinstance(layer, MBInvertedResBlock):
        mc, f = layer.mid_channels, 0.0
        if layer.has_expand:
            f += _conv(1, layer.in_channels, mc, layer.groups, res, res,
                       layer.bias)
        o = _out_res(res, layer.stride, layer.kernel_size)
        f += _conv(layer.kernel_size, mc, mc, mc, o, o, layer.bias)
        if layer.se_channels:
            f += mc * o * o
            f += _conv(1, mc, layer.se_channels, layer.groups, 1, 1, True)
            f += _conv(1, layer.se_channels, mc, layer.groups, 1, 1, True)
        f += _conv(1, mc, layer.out_channels, layer.groups, o, o, layer.bias)
        return f, o
    raise TypeError(type(layer))


def evalnet_macs(net, image_size):
    """Multiply-accumulates of one image through a reference EvalNet."""
    total, res = 0.0, image_size
    for layer in [net.first_stem] + net.blocks:
        f, res = layer_macs(layer, res)
        total += f
    f, res = layer_macs(net.feature_mix, res)
    total += f + net.feature_mix.out_channels * res * res
    return total + layer_macs(net.classifier, 1)[0]


def _candidate(site, op, live):
    return MBInvertedResBlock(site.ic, live, OP_SE_MULT[op] * site.ic,
                              site.oc, OP_KERNEL[op], site.stride,
                              act_func=site.act)


class SupernetMacs:
    """Multiply-accumulates of one image through the parts of a reference
    SuperNet: the stem, each candidate of each block at its live width
    (from a mc_mask_dddict), the head."""

    def __init__(self, net, mc_mask_dddict):
        sp = net.space
        res = sp.image_size
        self.stem = 0.0
        for layer in (net.first_stem, net.second_stem):
            f, res = layer_macs(layer, res)
            self.stem += f
        self.ops = []  # [block][op]
        for s in sp.sites:
            row = []
            for op in range(8):
                live = int(mc_mask_dddict[s.stage][s.block][op].sum())
                row.append(layer_macs(_candidate(s, op, live), s.res)[0])
            self.ops.append(row)
            res = s.res // s.stride if s.stride > 1 else s.res
        f, res = layer_macs(net.feature_mix, res)
        self.head = (f + net.feature_mix.out_channels * res * res
                     + layer_macs(net.classifier, 1)[0])

    def sampled(self, idx):
        """One sampled path (op index per block) without the stem."""
        return sum(self.ops[b][int(o)] for b, o in enumerate(idx)) + self.head

    def weight_step(self, idx_g, idx_r, batch):
        """FLOPs of a bi-sampling weight step: forward of the shared stem
        and both paths, 3x for the backward."""
        fwd = self.stem + self.sampled(idx_g) + self.sampled(idx_r)
        return 2.0 * 3.0 * fwd * batch

    def arch_step(self, batch):
        """FLOPs of a soft arch step: every candidate, 2x for the
        input-only backward."""
        fwd = self.stem + sum(sum(row) for row in self.ops) + self.head
        return 2.0 * 2.0 * fwd * batch
