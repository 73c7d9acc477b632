"""Plain PyTorch layers of the TF-NAS networks, the benchmark's reference.

A frozen copy of the port's layer arithmetic (activations, batch norm,
convolutions, the MBConv block, the losses), kept here so that later
changes to the port cannot move the yardstick. It imports nothing of the
port. Activations are NCHW; convolution kernels OIHW; dense kernels
[in, out]. Everything runs in the dtype of its input: the reference runs
in float32 with TF32 off (`strict_float32`).

`LOWP` is the rounding applied to the operands of every convolution and
matrix product. It is the identity for the reference; the control of a
cell (`lowp.py`) sets it to a lower precision for the span of one run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN = {"momentum": 0.1}  # running-statistics momentum; 1.0 to calibrate


def _identity(t):
    return t


LOWP = {"round": _identity}


def rnd(t):
    """The operand rounding of the current mode (identity by default)."""
    return LOWP["round"](t)


def strict_float32():
    """Full float32 products: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- activations --------------------------------------------------------------

def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


ACT_FNS = {
    "relu": torch.relu,
    "relu6": _relu6,
    "swish": lambda x: x * torch.sigmoid(x),
    "h-swish": lambda x: x * _relu6(x + 3.0) * (1.0 / 6.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def apply_act(x, act):
    return x if act is None else ACT_FNS[act](x)


# -- primitives ---------------------------------------------------------------

class Pool:
    """Uniform [0, 1) values from a torch.Generator, drawn on its device in
    chunks of CHUNK values and handed out in slices, so that a network's
    weights take a few large draws and not one per leaf."""

    CHUNK = 1 << 24

    def __init__(self, generator):
        self.generator, self.device = generator, generator.device
        self.buf, self.off = None, 0

    def rand(self, shape):
        n = math.prod(shape)
        if n > self.CHUNK:
            return torch.rand(shape, generator=self.generator,
                              device=self.device)
        if self.buf is None or self.off + n > self.buf.numel():
            self.buf = torch.rand(self.CHUNK, generator=self.generator,
                                  device=self.device)
            self.off = 0
        self.off += n
        return self.buf[self.off - n:self.off].view(shape)


def uniform_init(shape, fan_in, pool):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from a Pool."""
    bound = 1.0 / math.sqrt(float(fan_in)) if fan_in > 0 else 0.0
    return pool.rand(shape) * (2.0 * bound) - bound


def conv2d(x, kernel, *, stride=1, groups=1, bias=None):
    """NCHW convolution with symmetric k // 2 padding."""
    y = F.conv2d(rnd(x), rnd(kernel.to(x.dtype)), None, stride,
                 kernel.shape[-1] // 2, 1, groups)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y


def linear(x, params):
    y = rnd(x) @ rnd(params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def batch_norm(x, params, state, *, affine, training, eps=BN_EPS):
    """(y, new_state) over the channel axis of NCHW or NC x. Batch moments
    when training or affine-free (biased variance); the running statistics
    otherwise. Running variance is updated unbiased."""
    dims = (0,) + tuple(range(2, x.dim()))
    if affine and not training:
        mean, var, new_state = state["mean"], state["var"], state
    else:
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean
        new_state = state
        momentum = BN["momentum"]
        if affine:
            n = x.numel() // x.shape[1]
            unbiased = var * (n / max(n - 1.0, 1.0))
            new_state = {
                "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
                "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
            }
    scale = torch.rsqrt(var + eps)
    offset = -mean * scale
    if affine:
        offset = offset * params["scale"] + params["bias"]
        scale = scale * params["scale"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.view(shape) + offset.view(shape), new_state


def init_bn(c, affine, device):
    if not affine:
        return {}, {}
    return ({"scale": torch.ones(c, device=device),
             "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)})


# -- losses -------------------------------------------------------------------

def nll(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[:, None].long())[:, 0]


def cross_entropy(logits, targets):
    return nll(logits, targets).mean()


def cross_entropy_label_smooth(logits, targets, num_classes, epsilon):
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(targets.long(), num_classes).to(logp.dtype)
    smooth = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-smooth * logp).mean(dim=0).sum()


# -- layers -------------------------------------------------------------------

def _ops(order):
    return order.split("_")


def _bn_first(order):
    for op in _ops(order):
        if op in ("bn", "weight"):
            return op == "bn"
    raise ValueError(order)


@dataclasses.dataclass(frozen=True)
class ConvLayer:
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

    def init(self, generator):
        k = self.kernel_size
        cin = self.in_channels // self.groups
        conv = {"kernel": uniform_init((self.out_channels, cin, k, k),
                                       k * k * cin, generator)}
        if self.bias:
            conv["bias"] = torch.zeros(self.out_channels,
                                       device=generator.device)
        params, state = {"conv": conv}, {}
        if self.use_bn:
            c = (self.in_channels if _bn_first(self.ops_order)
                 else self.out_channels)
            params["bn"], state["bn"] = init_bn(c, self.affine,
                                                generator.device)
        return params, state

    def apply(self, params, state, x, *, training=False):
        new_state = dict(state)
        for op in _ops(self.ops_order):
            if op == "weight":
                x = conv2d(x, params["conv"]["kernel"], stride=self.stride,
                           groups=self.groups,
                           bias=params["conv"].get("bias"))
            elif op == "bn" and self.use_bn:
                x, new_state["bn"] = batch_norm(
                    x, params.get("bn", {}), state.get("bn", {}),
                    affine=self.affine, training=training)
            elif op == "act":
                x = apply_act(x, self.act_func)
        return x, new_state


@dataclasses.dataclass(frozen=True)
class LinearLayer:
    in_features: int
    out_features: int
    bias: bool = True
    use_bn: bool = False
    affine: bool = False
    act_func: Optional[str] = None
    ops_order: str = "weight_bn_act"

    def init(self, generator):
        p = {"kernel": uniform_init((self.in_features, self.out_features),
                                    self.in_features, generator)}
        if self.bias:
            p["bias"] = torch.zeros(self.out_features,
                                    device=generator.device)
        return {"linear": p}, {}

    def apply(self, params, state, x, *, training=False):
        x = linear(x, params["linear"])
        return apply_act(x, self.act_func), dict(state)


@dataclasses.dataclass(frozen=True)
class MBInvertedResBlock:
    """1x1 expand (+BN+act) -> kxk depthwise (+BN+act) -> SE gate -> 1x1
    project (+BN) -> residual when ic == oc and stride 1, drop-connect on
    the branch when training."""
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

    def __post_init__(self):
        if self.mid_channels <= self.in_channels:
            object.__setattr__(self, "mid_channels", self.in_channels)
        if self.se_channels <= 0:
            object.__setattr__(self, "se_channels", 0)

    @property
    def has_expand(self):
        return self.mid_channels > self.in_channels

    @property
    def has_residual(self):
        return self.in_channels == self.out_channels and self.stride == 1

    def _conv_bn(self, kernel, generator):
        p, s = {"conv": {"kernel": kernel}}, {}
        if self.use_bn:
            p["bn"], s["bn"] = init_bn(kernel.shape[0], self.affine,
                                       generator.device)
        return p, s

    def init(self, generator):
        params, state = {}, {}
        mc, k = self.mid_channels, self.kernel_size
        if self.has_expand:
            params["inverted_bottleneck"], state["inverted_bottleneck"] = \
                self._conv_bn(uniform_init((mc, self.in_channels, 1, 1),
                                           self.in_channels, generator),
                              generator)
        params["depth_conv"], state["depth_conv"] = self._conv_bn(
            uniform_init((mc, 1, k, k), k * k, generator), generator)
        if self.se_channels:
            se = self.se_channels
            params["squeeze_excite"] = {
                "conv_reduce": {"kernel": uniform_init((mc, se), mc,
                                                       generator),
                                "bias": uniform_init((se,), mc, generator)},
                "conv_expand": {"kernel": uniform_init((se, mc), se,
                                                       generator),
                                "bias": uniform_init((mc,), se, generator)},
            }
        params["point_linear"], state["point_linear"] = self._conv_bn(
            uniform_init((self.out_channels, mc, 1, 1), mc, generator),
            generator)
        return params, state

    def _bn(self, x, params, state, new_state, name, training):
        if not self.use_bn:
            return x
        x, new_state.setdefault(name, {})["bn"] = batch_norm(
            x, params[name].get("bn", {}), state.get(name, {}).get("bn", {}),
            affine=self.affine, training=training)
        return x

    def apply(self, params, state, x, *, training=False, keep=None):
        new_state = {k: dict(v) for k, v in state.items()}
        res = x
        if self.has_expand:
            x = conv2d(x, params["inverted_bottleneck"]["conv"]["kernel"],
                       bias=params["inverted_bottleneck"]["conv"].get("bias"))
            x = self._bn(x, params, state, new_state, "inverted_bottleneck",
                         training)
            x = apply_act(x, self.act_func)
        x = conv2d(x, params["depth_conv"]["conv"]["kernel"],
                   stride=self.stride, groups=self.mid_channels,
                   bias=params["depth_conv"]["conv"].get("bias"))
        x = self._bn(x, params, state, new_state, "depth_conv", training)
        x = apply_act(x, self.act_func)
        if self.se_channels:
            se = params["squeeze_excite"]
            z = apply_act(linear(x.mean(dim=(2, 3)), se["conv_reduce"]),
                          self.act_func)
            gate = torch.sigmoid(linear(z, se["conv_expand"]))
            x = x * gate[:, :, None, None]
        x = conv2d(x, params["point_linear"]["conv"]["kernel"],
                   bias=params["point_linear"]["conv"].get("bias"))
        x = self._bn(x, params, state, new_state, "point_linear", training)
        if self.has_residual:
            if self.drop_connect_rate > 0.0 and training and keep is not None:
                x = x / (1.0 - self.drop_connect_rate) * keep.to(
                    x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
            x = x + res
        return x, new_state


_LAYERS = {"ConvLayer": ConvLayer, "LinearLayer": LinearLayer,
           "MBInvertedResBlock": MBInvertedResBlock}


def layer_from_config(cfg):
    cfg = dict(cfg)
    return _LAYERS[cfg.pop("name")](**cfg)
