"""The layers of the supernet and of the fixed-architecture eval network
(counterpart of tfnas_tpu/ops/layers.py).

Each layer is a frozen dataclass describing shapes and flags, with
`init(generator) -> (params, state)` and
`apply(params, state, x, training=...) -> (y, new_state)` over plain
dictionaries of tensors, so the parameter trees match the JAX package's key
for key. Activations are NCHW. `config` emits the model.config JSON entry
of a layer and `set_layer_from_config` reads one back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .activations import apply_act
from .batchnorm import batch_norm, init_bn
from .conv import (channel_shuffle, conv2d, global_avg_pool,
                   init_conv_kernel, init_linear, linear, torch_uniform_init)


def _ops_list(ops_order):
    return ops_order.split("_")


def _bn_before_weight(ops_order):
    for op in _ops_list(ops_order):
        if op == "bn":
            return True
        if op == "weight":
            return False
    raise ValueError(f"Invalid ops_order: {ops_order}")


def drop_connect(x, keep, drop_rate):
    """Per-sample stochastic depth: x / keep_prob * keep, in f32. keep: the
    [N] 0/1 draw, floor(keep_prob + U[0, 1)) in the JAX package."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = keep.to(torch.float32).reshape(shape)
    return (x.float() / (1.0 - drop_rate) * keep).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """Conv2d + optional BN + act in a configurable order."""

    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    groups: int = 1
    has_shuffle: bool = False
    bias: bool = False
    use_bn: bool = True
    affine: bool = True
    act_func: Optional[str] = "relu6"
    ops_order: str = "weight_bn_act"

    name = "ConvLayer"

    @property
    def bn_before_weight(self):
        return _bn_before_weight(self.ops_order)

    @property
    def config(self):
        return {
            "name": "ConvLayer",
            "kernel_size": self.kernel_size,
            "stride": self.stride,
            "groups": self.groups,
            "has_shuffle": self.has_shuffle,
            "bias": self.bias,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "use_bn": self.use_bn,
            "affine": self.affine,
            "act_func": self.act_func,
            "ops_order": self.ops_order,
        }

    def init(self, generator):
        k = self.kernel_size
        conv = {"kernel": init_conv_kernel(k, k,
                                           self.in_channels // self.groups,
                                           self.out_channels, generator)}
        if self.bias:
            conv["bias"] = torch.zeros(self.out_channels,
                                       device=generator.device)
        params, state = {"conv": conv}, {}
        if self.use_bn:
            c = (self.in_channels if self.bn_before_weight
                 else self.out_channels)
            params["bn"], state["bn"] = init_bn(c, self.affine,
                                                generator.device)
        return params, state

    def apply(self, params, state, x, *, training=False, bn_group=None):
        new_state = dict(state)
        for op in _ops_list(self.ops_order):
            if op == "weight":
                x = conv2d(x, params["conv"]["kernel"], stride=self.stride,
                           groups=self.groups,
                           bias=params["conv"].get("bias"))
                if self.has_shuffle and self.groups > 1:
                    x = channel_shuffle(x, self.groups)
            elif op == "bn":
                if self.use_bn:
                    x, new_state["bn"] = batch_norm(
                        x, params.get("bn", {}), state.get("bn", {}),
                        affine=self.affine, training=training,
                        group=bn_group)
            elif op == "act":
                x = apply_act(x, self.act_func)
            else:
                raise ValueError(f"Unrecognized op: {op}")
        return x, new_state


@dataclasses.dataclass(frozen=True)
class IdentityLayer:
    """Pass-through layer with optional BN + act."""

    in_channels: int
    out_channels: int
    use_bn: bool = False
    affine: bool = False
    act_func: Optional[str] = None
    ops_order: str = "weight_bn_act"

    name = "IdentityLayer"

    @property
    def config(self):
        return {
            "name": "IdentityLayer",
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "use_bn": self.use_bn,
            "affine": self.affine,
            "act_func": self.act_func,
            "ops_order": self.ops_order,
        }

    def init(self, generator):
        params, state = {}, {}
        if self.use_bn:
            params["bn"], state["bn"] = init_bn(self.out_channels,
                                                self.affine, generator.device)
        return params, state

    def apply(self, params, state, x, *, training=False, bn_group=None):
        new_state = dict(state)
        for op in _ops_list(self.ops_order):
            if op == "bn" and self.use_bn:
                x, new_state["bn"] = batch_norm(
                    x, params.get("bn", {}), state.get("bn", {}),
                    affine=self.affine, training=training, group=bn_group)
            elif op == "act":
                x = apply_act(x, self.act_func)
        return x, new_state


@dataclasses.dataclass(frozen=True)
class LinearLayer:
    """FC + optional BN1d + act: the classifier head."""

    in_features: int
    out_features: int
    bias: bool = True
    use_bn: bool = False
    affine: bool = False
    act_func: Optional[str] = None
    ops_order: str = "weight_bn_act"

    name = "LinearLayer"

    @property
    def config(self):
        return {
            "name": "LinearLayer",
            "in_features": self.in_features,
            "out_features": self.out_features,
            "bias": self.bias,
            "use_bn": self.use_bn,
            "affine": self.affine,
            "act_func": self.act_func,
            "ops_order": self.ops_order,
        }

    def init(self, generator):
        params = {"linear": init_linear(self.in_features, self.out_features,
                                        generator, bias=self.bias)}
        state = {}
        if self.use_bn:
            c = (self.in_features if _bn_before_weight(self.ops_order)
                 else self.out_features)
            params["bn"], state["bn"] = init_bn(c, self.affine,
                                                generator.device)
        return params, state

    def apply(self, params, state, x, *, training=False, bn_group=None):
        new_state = dict(state)
        for op in _ops_list(self.ops_order):
            if op == "weight":
                x = linear(x, params["linear"])
            elif op == "bn":
                if self.use_bn:
                    x, new_state["bn"] = batch_norm(
                        x, params.get("bn", {}), state.get("bn", {}),
                        affine=self.affine, training=training,
                        group=bn_group)
            elif op == "act":
                x = apply_act(x, self.act_func)
            else:
                raise ValueError(f"Unrecognized op: {op}")
        return x, new_state


@dataclasses.dataclass(frozen=True)
class MBInvertedResBlock:
    """MobileNet inverted residual block with optional SE.

    1x1 expand conv (+BN+act) -> kxk depthwise (+BN+act) -> optional SE
    gate -> 1x1 project conv (+BN) -> residual add iff ic == oc and
    stride == 1, with drop-connect on the residual branch when training.
    The expand conv is omitted, and mid_channels snaps to in_channels, when
    mid_channels <= in_channels.
    """

    in_channels: int
    mid_channels: int
    se_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    groups: int = 1
    has_shuffle: bool = False
    bias: bool = False
    use_bn: bool = True
    affine: bool = True
    act_func: Optional[str] = "relu6"
    drop_connect_rate: float = 0.0

    name = "MBInvertedResBlock"

    def __post_init__(self):
        if self.mid_channels <= self.in_channels:
            object.__setattr__(self, "mid_channels", self.in_channels)
        if self.se_channels <= 0:
            object.__setattr__(self, "se_channels", 0)

    @property
    def has_expand(self):
        return self.mid_channels > self.in_channels

    @property
    def has_se(self):
        return self.se_channels > 0

    @property
    def has_residual(self):
        return self.in_channels == self.out_channels and self.stride == 1

    @property
    def config(self):
        return {
            "name": "MBInvertedResBlock",
            "in_channels": self.in_channels,
            "mid_channels": self.mid_channels,
            "se_channels": self.se_channels,
            "out_channels": self.out_channels,
            "kernel_size": self.kernel_size,
            "stride": self.stride,
            "groups": self.groups,
            "has_shuffle": self.has_shuffle,
            "bias": self.bias,
            "use_bn": self.use_bn,
            "affine": self.affine,
            "act_func": self.act_func,
        }

    def _conv_bn(self, kernel, generator):
        conv = {"kernel": kernel}
        if self.bias:
            conv["bias"] = torch.zeros(kernel.shape[0],
                                       device=generator.device)
        sub_p, sub_s = {"conv": conv}, {}
        if self.use_bn:
            sub_p["bn"], sub_s["bn"] = init_bn(kernel.shape[0], self.affine,
                                               generator.device)
        return sub_p, sub_s

    def init(self, generator):
        params, state = {}, {}
        mc, k, g = self.mid_channels, self.kernel_size, self.groups
        if self.has_expand:
            params["inverted_bottleneck"], state["inverted_bottleneck"] = \
                self._conv_bn(init_conv_kernel(1, 1, self.in_channels // g,
                                               mc, generator), generator)
        params["depth_conv"], state["depth_conv"] = self._conv_bn(
            init_conv_kernel(k, k, 1, mc, generator), generator)
        if self.has_se:
            sec = self.se_channels
            params["squeeze_excite"] = {
                "conv_reduce": {
                    "kernel": torch_uniform_init((mc, sec), mc, generator),
                    "bias": torch_uniform_init((sec,), mc, generator),
                },
                "conv_expand": {
                    "kernel": torch_uniform_init((sec, mc), sec, generator),
                    "bias": torch_uniform_init((mc,), sec, generator),
                },
            }
        params["point_linear"], state["point_linear"] = self._conv_bn(
            init_conv_kernel(1, 1, mc // g, self.out_channels, generator),
            generator)
        return params, state

    def _bn(self, x, params, state, new_state, name, training, group):
        if not self.use_bn:
            return x
        x, new_state.setdefault(name, {})["bn"] = batch_norm(
            x, params[name].get("bn", {}), state.get(name, {}).get("bn", {}),
            affine=self.affine, training=training, group=group)
        return x

    def _conv(self, x, params, name, stride=1, groups=None):
        conv = params[name]["conv"]
        return conv2d(x, conv["kernel"], stride=stride,
                      groups=self.groups if groups is None else groups,
                      bias=conv.get("bias"))

    def apply(self, params, state, x, *, training=False, keep=None,
              bn_group=None):
        """keep: the [N] 0/1 drop-connect draw of this block (used when
        training with drop_connect_rate > 0 and a residual); bn_group: the
        process group of cross-replica BN."""
        new_state = {k: dict(v) for k, v in state.items()}
        shuffle = self.has_shuffle and self.groups > 1
        res = x
        if self.has_expand:
            x = self._conv(x, params, "inverted_bottleneck")
            x = self._bn(x, params, state, new_state, "inverted_bottleneck",
                         training, bn_group)
            x = apply_act(x, self.act_func)
            if shuffle:
                x = channel_shuffle(x, self.groups)
        x = self._conv(x, params, "depth_conv", self.stride,
                       self.mid_channels)
        x = self._bn(x, params, state, new_state, "depth_conv", training,
                     bn_group)
        x = apply_act(x, self.act_func)
        if self.has_se:
            se = params["squeeze_excite"]
            z = apply_act(linear(global_avg_pool(x), se["conv_reduce"]),
                          self.act_func)
            z = linear(z, se["conv_expand"])
            gate = torch.sigmoid(z.float()).to(x.dtype)
            x = x * gate[:, :, None, None]
        x = self._conv(x, params, "point_linear")
        x = self._bn(x, params, state, new_state, "point_linear", training,
                     bn_group)
        if shuffle:
            x = channel_shuffle(x, self.groups)
        if self.has_residual:
            if self.drop_connect_rate > 0.0 and training and keep is not None:
                x = drop_connect(x, keep, self.drop_connect_rate)
            x = x + res
        return x, new_state


@dataclasses.dataclass(frozen=True)
class MBConvPreNorm:
    """CoAtNet's pre-norm MBConv block (arXiv:2106.04803, eq. 5):

        h = BN0(x)
        h = act(BN1(Conv1x1_s(h, ic -> mc)))     stride s in this 1x1 conv
        h = act(BN2(DWkxk(h)))
        h = h * sigmoid(W2 act(W1 mean_hw(h)))   SE of se_channels
        y = sc + drop_connect(Conv1x1(h, mc -> oc))

    with sc = MaxPool2x2_s2(x) when s > 1, then a 1x1 projection when
    ic != oc; sc = x otherwise. Both branches add, so every block takes a
    drop-connect draw. The convolutions carry no bias while use_bn; the
    BN-folded block (models/folding.py) has use_bn=False and a bias on each
    convolution, BN0 folded into the first one.
    """

    in_channels: int
    mid_channels: int
    se_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    use_bn: bool = True
    act_func: Optional[str] = "gelu"
    drop_connect_rate: float = 0.0

    name = "MBConvPreNorm"
    has_residual = True

    @property
    def has_proj(self):
        return self.in_channels != self.out_channels

    @property
    def config(self):
        return {
            "name": "MBConvPreNorm",
            "in_channels": self.in_channels,
            "mid_channels": self.mid_channels,
            "se_channels": self.se_channels,
            "out_channels": self.out_channels,
            "kernel_size": self.kernel_size,
            "stride": self.stride,
            "use_bn": self.use_bn,
            "act_func": self.act_func,
        }

    def _conv_bn(self, kernel, generator, bn=True):
        conv = {"kernel": kernel}
        if not self.use_bn:
            conv["bias"] = torch.zeros(kernel.shape[0],
                                       device=generator.device)
        p, s = {"conv": conv}, {}
        if bn and self.use_bn:
            p["bn"], s["bn"] = init_bn(kernel.shape[0], True,
                                       generator.device)
        return p, s

    def init(self, generator):
        ic, mc, oc, k = (self.in_channels, self.mid_channels,
                         self.out_channels, self.kernel_size)
        dev = generator.device
        params, state = {}, {}
        if self.use_bn:
            params["pre_norm"], state["pre_norm"] = {}, {}
            params["pre_norm"]["bn"], state["pre_norm"]["bn"] = init_bn(
                ic, True, dev)
        params["inverted_bottleneck"], state["inverted_bottleneck"] = \
            self._conv_bn(init_conv_kernel(1, 1, ic, mc, generator),
                          generator)
        params["depth_conv"], state["depth_conv"] = self._conv_bn(
            init_conv_kernel(k, k, 1, mc, generator), generator)
        sec = self.se_channels
        params["squeeze_excite"] = {
            "conv_reduce": {
                "kernel": torch_uniform_init((mc, sec), mc, generator),
                "bias": torch_uniform_init((sec,), mc, generator),
            },
            "conv_expand": {
                "kernel": torch_uniform_init((sec, mc), sec, generator),
                "bias": torch_uniform_init((mc,), sec, generator),
            },
        }
        params["point_linear"], _ = self._conv_bn(
            init_conv_kernel(1, 1, mc, oc, generator), generator, bn=False)
        if self.has_proj:
            params["shortcut"], _ = self._conv_bn(
                init_conv_kernel(1, 1, ic, oc, generator), generator,
                bn=False)
        return params, state

    def _conv_bn_act(self, x, params, state, new_state, name, training,
                     group, stride=1, groups=1, act=True):
        conv = params[name]["conv"]
        x = conv2d(x, conv["kernel"], stride=stride, groups=groups,
                   bias=conv.get("bias"))
        if "bn" in params[name]:
            x, new_state.setdefault(name, {})["bn"] = batch_norm(
                x, params[name]["bn"], state[name]["bn"], affine=True,
                training=training, group=group)
        return apply_act(x, self.act_func) if act else x

    def apply(self, params, state, x, *, training=False, keep=None,
              bn_group=None):
        """keep: the [N] 0/1 drop-connect draw (used when training with a
        rate > 0); bn_group: the process group of cross-replica BN."""
        new_state = {k: dict(v) for k, v in state.items()}
        sc = x
        if self.stride > 1:
            sc = F.max_pool2d(sc, self.stride, self.stride)
        if self.has_proj:
            sc = self._conv_bn_act(sc, params, state, new_state, "shortcut",
                                   training, bn_group, act=False)
        h = x
        if "pre_norm" in params:
            h, new_state["pre_norm"]["bn"] = batch_norm(
                h, params["pre_norm"]["bn"], state["pre_norm"]["bn"],
                affine=True, training=training, group=bn_group)
        h = self._conv_bn_act(h, params, state, new_state,
                              "inverted_bottleneck", training, bn_group,
                              stride=self.stride)
        h = self._conv_bn_act(h, params, state, new_state, "depth_conv",
                              training, bn_group, groups=self.mid_channels)
        se = params["squeeze_excite"]
        z = apply_act(linear(global_avg_pool(h), se["conv_reduce"]),
                      self.act_func)
        gate = torch.sigmoid(linear(z, se["conv_expand"]).float())
        h = h * gate.to(h.dtype)[:, :, None, None]
        h = self._conv_bn_act(h, params, state, new_state, "point_linear",
                              training, bn_group, act=False)
        if self.drop_connect_rate > 0.0 and training and keep is not None:
            h = drop_connect(h, keep, self.drop_connect_rate)
        return sc + h, new_state


# -- config (de)serialisation ----------------------------------------------

_NAME2LAYER = {
    "ConvLayer": ConvLayer,
    "IdentityLayer": IdentityLayer,
    "LinearLayer": LinearLayer,
    "MBInvertedResBlock": MBInvertedResBlock,
    "MBConvPreNorm": MBConvPreNorm,
}


def set_layer_from_config(layer_config):
    """model.config entry -> layer object; the input dict is not changed."""
    if layer_config is None:
        return None
    cfg = dict(layer_config)
    name = cfg.pop("name")
    if name == "ViTBlock":  # the hybrid space's candidate (ops/attention.py)
        from .attention import ViTBlock
        return ViTBlock(**cfg)
    if name == "RelTransformerBlock":  # CoAtNet's (ops/attention.py)
        from .attention import RelTransformerBlock
        return RelTransformerBlock(**cfg)
    return _NAME2LAYER[name](**cfg)
