"""Model FLOPs of CoAtNet from the shapes of the reference's layer objects
(benchmark/reference/coatnet.py), by the rules of benchmark/flops.py:
multiply-accumulates counted once, a FLOP is two of them, a training
step is three times its forward.

- a convolution: k * k * cin * cout / groups * oh * ow (+ cout * oh * ow
  with a bias); a linear: in * out (+ out with a bias); a global average
  pool: C * h * w;
- the pre-norm MBConv block: its 1x1 convolutions at the output
  resolution (the stride is in the first), the depthwise convolution, the
  SE pool and linears, the 1x1 shortcut projection where ic != oc; BN and
  the max pool count nothing;
- the transformer block: the shortcut linear, QKV from ic, q.k^T and
  attn.v over the T tokens of the (pooled) grid, the out projection and
  the two feed-forward linears; the relative bias counts nothing.

CoAtNet-2 at 224^2 counts 15.52 G: S0 1.895, S1 0.854, S2 2.438, S3
9.144, S4 1.193 (+ the head); the paper states 15.7 G.
"""

from __future__ import annotations

from .reference.coatnet import ConvLayer, MBConvPreNorm, RelTransformerBlock


def _conv(k, cin, cout, groups, o, bias):
    return k * k * cin * cout / groups * o * o + (cout * o * o if bias
                                                  else 0.0)


def layer_macs(layer, res):
    """(multiply-accumulates, output resolution) of one layer at square
    input resolution res."""
    if isinstance(layer, ConvLayer):
        o = (res + 2 * (layer.kernel_size // 2) - layer.kernel_size) \
            // layer.stride + 1
        return _conv(layer.kernel_size, layer.in_channels,
                     layer.out_channels, layer.groups, o, layer.bias), o
    if isinstance(layer, MBConvPreNorm):
        c, m, oc = layer.in_channels, layer.mid_channels, layer.out_channels
        o, se = res // layer.stride, layer.se_channels
        f = _conv(1, c, m, 1, o, False)
        f += _conv(layer.kernel_size, m, m, m, o, False)
        f += m * o * o + (m * se + se) + (se * m + m)
        f += _conv(1, m, oc, 1, o, False)
        if c != oc:
            f += _conv(1, c, oc, 1, o, False)
        return f, o
    if isinstance(layer, RelTransformerBlock):
        c, m, oc = layer.in_channels, layer.mid_channels, layer.out_channels
        o = res // layer.stride
        t = o * o
        f = 0.0
        if layer.stride > 1 or c != oc:
            f += t * (c * oc + oc)
        f += t * (3 * c * oc + 3 * oc)
        f += 2.0 * t * t * oc
        f += t * (oc * oc + oc) + t * (oc * m + m) + t * (m * oc + oc)
        return f, o
    raise TypeError(type(layer))


def coatnet_macs(net, image_size):
    """Multiply-accumulates of one image through a reference CoAtNet."""
    total, res = 0.0, image_size
    for layer in [net.first_stem, net.second_stem] + net.blocks:
        f, res = layer_macs(layer, res)
        total += f
    c = net.classifier
    return total + c.in_features * res * res + (c.in_features *
                                                c.out_features
                                                + c.out_features)

