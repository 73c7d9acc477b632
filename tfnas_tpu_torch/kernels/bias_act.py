"""The epilogue of a biased convolution or linear layer in one pass:
`out = act(x * gate + bias) + residual`.

x is the layer's output without its bias: `[N, C, H, W]` in channels_last
(or contiguous NCHW) memory, or `[N, C]` rows; bias `[C]`, f32 or bf16 as
stored (read in f32, never cast first); gate `[N, C]`, a squeeze-excite
gate per image and channel; residual x's shape and layout; act one of `ops/activations.ACT_FNS`. Every
operand but x is optional. The maths is f32 (float64 for float64 x, which
only the plain version takes), rounded once to x's dtype.

On a CUDA tensor `bias_act` launches the hand-written kernel in
`csrc/bias_act.cu` (built with nvcc for sm_90a into `build/tfnas_tpu_torch/`
at first use, its own library, loaded with ctypes); on a CPU tensor it runs
`bias_act_plain`, the same function in plain PyTorch. A CUDA tensor never
falls back to the plain version: the kernel launches or the call raises.

Where the layers use it (ops/layers.py, models/folding.py): at each
epilogue of a layer with a bias and no BatchNorm between its weight and its
activation (the BN-folded net, `use_bn=False`), when none of the layer's
input and weights needs a gradient and, on the card, the input is f32 or
bf16 (`fusable`). Other sites keep PyTorch's ops, unchanged.

Counters since import (or `reset_counts`), read by `counts()`: `launches`
counts eager kernel launches; a call on a stream that is being captured
into a CUDA graph records a kernel node instead and counts in
`captured_nodes`, and `replayed_nodes` counts the nodes that replays of
captured graphs ran (the counter
`utils/trace.launch_counters["bias_act"]`, under the one key
"epilogue"). `unfused` counts epilogue sites on a CUDA tensor that
kept PyTorch's ops because a gradient was needed. Plain-version calls on
CPU tensors count nowhere.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
from pathlib import Path

import torch

from ..ops.activations import apply_act
from . import nvcc

# activation codes understood by the kernel (`activate` in bias_act.cu)
ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "swish": 3, "h-swish": 4,
             "sigmoid": 5, "tanh": 6, "gelu": 7}
VEC = 8  # channels a thread of the kernel's vector path takes
DTYPES = (torch.float32, torch.bfloat16)  # of x, bias and gate
MAX_NUMEL = 2 ** 31 - 1

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bias_act.cu"
# the C interface of csrc/bias_act.cu
_p, _i, _q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"tfnas_bias_act_forward": (
    [_p, _p, _i, _p, _i, _p, _p, _q, _q, _q, _i, _i, _i, _i, _p], _i)}

_counter = nvcc.LaunchCounter("bias_act", ("epilogue",))
unfused = 0
# how the loaded library was obtained: {"path", "seconds", "log"}
build_info = None
# why the library could not be built or loaded, once that was tried
build_error = None
_lib = None


def reset_counts():
    global unfused
    _counter.reset()
    unfused = 0


def counts():
    """The counts since the last reset: eager launches, nodes recorded at
    capture, nodes run by replays, and card sites left unfused."""
    return {k: v["epilogue"] for k, v in _counter.counts().items()} | {
        "unfused": unfused}


def build_library():
    """Compile csrc/bias_act.cu into a C-ABI shared library under
    nvcc.BUILD_DIR, once per source content and flags, and return its
    path."""
    return nvcc.build_library(sys.modules[__name__], "libbias_act")


def fusable(tensors, sites=1):
    """True where `sites` epilogue sites over `tensors` (a layer's input
    first, then its weights) take `bias_act`: none of them needs a
    gradient, and an input on the card is of a dtype the kernel takes.
    Sites on the card that keep PyTorch's ops for a gradient count in
    `unfused`."""
    global unfused
    ts = list(tensors)
    if ts[0].is_cuda and ts[0].dtype not in DTYPES:
        return False
    if not torch.is_grad_enabled():
        return True
    if not any(t.requires_grad for t in ts):
        return True
    if ts[0].is_cuda:
        unfused += sites
    return False


def _layout(x):
    """1 for a contiguous NCHW map, 0 for channels_last maps and [N, C]
    rows; raises on anything else."""
    if x.dim() == 2 and x.is_contiguous():
        return 0
    if x.dim() == 4:
        if x.is_contiguous(memory_format=torch.channels_last):
            return 0
        if x.is_contiguous():
            return 1
    raise ValueError("x must be [N, C] rows or an [N, C, H, W] map in "
                     "channels_last or contiguous NCHW memory")


def _check(name, t, x, dtypes, shape):
    if (t.device != x.device or t.dtype not in dtypes
            or tuple(t.shape) != shape or not t.is_contiguous()):
        kinds = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{name} must be a contiguous {kinds} tensor of "
                         f"shape {shape} on {x.device}")


def bias_act_cuda(x, bias=None, act=None, gate=None, residual=None):
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take."""
    if not x.is_cuda:
        raise ValueError("bias_act_cuda needs CUDA tensors")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"unsupported act {act!r}")
    if not 0 < x.numel() <= MAX_NUMEL:
        raise ValueError(f"x must hold 1 to {MAX_NUMEL} elements")
    nchw = _layout(x)
    n, c = x.shape[:2]
    if bias is not None:
        _check("bias", bias, x, DTYPES, (c,))
    if gate is not None:
        _check("gate", gate, x, DTYPES, (n, c))
    if residual is not None:
        if (residual.device != x.device or residual.dtype != x.dtype
                or residual.shape != x.shape or _layout(residual) != nchw):
            raise ValueError("residual must be x's dtype, shape and layout "
                             "on its device")
    out = torch.empty_like(x)
    ops = [t for t in (x, bias, gate, residual, out) if t is not None]
    vec = int(not nchw and c % VEC == 0
              and all(t.data_ptr() % 16 == 0 for t in ops))
    lib = nvcc.load(sys.modules[__name__], SIGNATURES)
    # the device guard only when x is not on the current device: entering
    # it costs host time on every call
    guard = (contextlib.nullcontext()
             if x.device.index == torch.cuda.current_device()
             else torch.cuda.device(x.device))
    with guard:
        rc = lib.tfnas_bias_act_forward(
            x.data_ptr(), None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.bfloat16),
            None if gate is None else gate.data_ptr(),
            int(gate is not None and gate.dtype == torch.bfloat16),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), x.numel(), c, x.numel() // (n * c),
            int(x.dtype == torch.bfloat16), ACT_CODES[act], nchw, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bias_act kernel launch failed with CUDA error "
                           f"{rc}")
    _counter.count("epilogue")
    return out


def bias_act_plain(x, bias=None, act=None, gate=None, residual=None):
    """The plain PyTorch version: the same function as the kernel, as
    separate operations in f32 (float64 for float64 x)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    per_channel = (-1,) + (1,) * (x.dim() - 2)
    y = x.to(dt)
    if gate is not None:
        y = y * gate.to(dt).reshape(gate.shape + per_channel[1:])
    if bias is not None:
        y = y + bias.to(dt).reshape(per_channel)
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual.to(dt)
    return y.to(x.dtype)


def bias_act(x, bias=None, act=None, gate=None, residual=None):
    """act(x * gate + bias) + residual: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.is_cuda:
        return bias_act_cuda(x, bias, act, gate, residual)
    if x.device.type == "cpu":
        return bias_act_plain(x, bias, act, gate, residual)
    raise ValueError(f"bias_act has no version for device {x.device}")
