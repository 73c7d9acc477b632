"""Fused normalise + act -> 5x5 depthwise conv -> output statistics
(counterpart of tfnas_tpu/kernels/fused_dw.py).

`fused_dw_norm_act(x, w, scale, offset, stride, act)` returns
`(y, sum(y), sum(y^2))` with `y = depthwise5x5(act(x * scale + offset))`,
x `[N, H, W, C]`, w `[5, 5, C]`, scale/offset `[C]`, and the per-channel
sums in f32 (float64 for float64 x, which only the plain version takes).
It is differentiable through `FusedDwNormAct`.

On a CUDA tensor the forward launches the hand-written kernel in
`csrc/fused_dw.cu` (built with nvcc for sm_90a into `build/tfnas_tpu_torch/`
at first use, loaded with ctypes); on a CPU tensor it runs `fused_dw_plain`,
the same math in plain PyTorch. A CUDA tensor never falls back to the plain
version: the kernel launches or the call raises. `launches[stride]` counts
kernel launches at each stride (stride 1 replaces the TPU's `_kernel`,
stride 2 its `_kernel_s2`); a call on a stream that is being captured into
a CUDA graph records a kernel node instead and counts in
`captured[stride]`, and `replayed[stride]` counts the nodes that replays of
captured graphs ran (search/compiled.py adds them per replay). The
kernel's static work decomposition is chosen here by `plan` and passed to
it; `work_items` lists it in the kernel's order, for the CPU tests.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops.activations import apply_act
from ..ops.batchnorm import stat_dtype

KPAD = 2
# the kernel's fixed geometry (csrc/fused_dw.cu)
THREADS, WARPS = 256, 8
COLS = 4      # output columns a thread computes
GROUP = 64    # channels of one warp (32 lanes x a channel pair)
DEPTH = 6     # ring slots of input rows in shared memory
BLOCKS_PER_SM = 2  # 256 threads at up to 128 registers
SMEM_PER_SM = 228 * 1024   # H100: shared memory of one SM
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED = 1024       # the runtime's reserve per block

# activation codes understood by the kernel (`activate` in fused_dw.cu)
_ACT_CODES = {None: 0, "relu": 1, "swish": 2, "h-swish": 3, "relu6": 4}

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_dw.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tfnas_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches by stride since import (or the last reset); plain-version
# calls on CPU tensors do not count
launches = {1: 0, 2: 0}
# kernel nodes recorded into CUDA graphs under capture, and run by replays
captured = {1: 0, 2: 0}
replayed = {1: 0, 2: 0}
# how the loaded library was obtained: {"path", "seconds", "log"}
build_info = None
_lib = None


def reset_launches():
    for counts in (launches, captured, replayed):
        for stride in counts:
            counts[stride] = 0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fused_dw kernel is built with "
                       "the CUDA toolkit's nvcc on the machine with the card")


def build_library():
    """Compile csrc/fused_dw.cu into a C-ABI shared library under
    BUILD_DIR, once per source content and flags, and return its path."""
    global build_info
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_dw_{tag}.so"
    if out.exists():
        build_info = {"path": str(out), "seconds": 0.0, "log": "cached"}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(_SOURCE)], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_info = {"path": str(out), "seconds": time.perf_counter() - t0,
                  "log": proc.stderr.strip()}
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_dw_forward.argtypes = [p] * 6 + [i] * 11 + [p]
        lib.fused_dw_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


Plan = collections.namedtuple(
    "Plan", "vec_bytes cw cb sw iw rs strips segs items groups bpg "
            "blocks_per_sm smem")


@functools.lru_cache(maxsize=None)
def plan(n, h, w, c, stride, itemsize, sms):
    """The kernel's static decomposition of one call.

    A block of 8 warps owns `cb` channels and a strip of `sw` output
    columns (`cw` column warps of COLS columns: the least power of two up
    to 8 that covers the output width, the rest of the warps take more
    channels). Per channel group the items are (image, segment of `rs`
    output rows, strip), strip fastest; `bpg` blocks serve each group,
    block j walking items j, j + bpg, ... (`work_items`). The grid is
    `groups * bpg` blocks, at most `blocks_per_sm` on each of `sms` SMs at
    once; `rs` and `bpg` minimise the rows the busiest block streams. The
    copies are 16 bytes where C is a multiple of 16 bytes of channels,
    else one channel pair (`vec_bytes`)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    wide = 16 // itemsize
    vec_bytes = 16 if c % wide == 0 else 2 * itemsize
    cw = 1
    while cw < WARPS and cw * COLS < wo:
        cw *= 2
    cb, sw = GROUP * (WARPS // cw), COLS * cw
    iw = (sw - 1) * stride + 5
    smem = DEPTH * iw * cb * itemsize + 2 * cb * 4 + THREADS * 16
    blocks_per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    assert smem <= SMEM_PER_BLOCK and blocks_per_sm >= 1
    groups, strips = -(-c // cb), -(-wo // sw)
    slots = blocks_per_sm * sms
    best = None
    for segs in range(1, ho + 1):
        rs = -(-ho // segs)
        if -(-ho // rs) != segs:
            continue  # the same rs as a smaller segs
        items = n * segs * strips
        bpg = min(items, max(1, slots // groups))
        waves = -(-groups * bpg // slots)
        cost = waves * -(-items // bpg) * ((rs - 1) * stride + 5)
        if best is None or cost < best[0]:
            best = (cost, rs, segs, items, bpg)
    _, rs, segs, items, bpg = best
    return Plan(vec_bytes, cw, cb, sw, iw, rs, strips, segs, items, groups,
                bpg, blocks_per_sm, smem)


def work_items(p, n, h, w, stride):
    """Yield (block, channel range, image, output row range, output column
    range) for every item of plan `p`, in the kernel's order (block
    g * bpg + j of channel group g takes items j, j + bpg, ...)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    for g in range(p.groups):
        for j in range(p.bpg):
            for i in range(j, p.items, p.bpg):
                strip, seg = i % p.strips, (i // p.strips) % p.segs
                img = i // (p.strips * p.segs)
                yield (g * p.bpg + j, (g * p.cb, (g + 1) * p.cb), img,
                       (seg * p.rs, min(ho, (seg + 1) * p.rs)),
                       (strip * p.sw, min(wo, (strip + 1) * p.sw)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_dw_cuda(x, w, scale, offset, stride, act):
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take."""
    if not x.is_cuda:
        raise ValueError("fused_dw_cuda needs CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [N, H, W, C] tensor")
    n, h, wd, c = x.shape
    for name, t, shape in (("w", w, (5, 5, c)), ("scale", scale, (c,)),
                           ("offset", offset, (c,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {x.device}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if c % 2:
        raise ValueError("the kernel takes channel pairs: C must be even")
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported act {act!r}")
    if x.numel() == 0:
        raise ValueError("x must not be empty")
    p = plan(n, h, wd, c, stride, x.element_size(),
             _sm_count(x.device.index))
    if x.data_ptr() % p.vec_bytes:
        raise ValueError(f"x must be aligned to {p.vec_bytes} bytes for the "
                         f"kernel's copies")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    part = torch.empty((2, p.bpg, c), dtype=torch.float32, device=x.device)
    lib = _library()
    # the device guard only when x is not on the current device: entering
    # it costs host time on every call
    guard = (contextlib.nullcontext()
             if x.device.index == torch.cuda.current_device()
             else torch.cuda.device(x.device))
    with guard:
        rc = lib.fused_dw_forward(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            y.data_ptr(), part.data_ptr(), n, h, wd, c, stride,
            _ACT_CODES[act], int(x.dtype == torch.bfloat16), p.vec_bytes,
            p.cw, p.rs, p.bpg, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_dw kernel launch failed with CUDA error "
                           f"{rc}")
    (captured if torch.cuda.is_current_stream_capturing()
     else launches)[stride] += 1
    s, q = part.sum(dim=1).unbind(0)  # the bpg partial rows, in order
    return y, s, q


def _elementwise(x, scale, offset, act):
    """act(x * scale + offset) in the statistics dtype (f32, float64 for
    float64 x), rounded to x's dtype."""
    return apply_act(x.to(stat_dtype(x.dtype)) * scale + offset,
                     act).to(x.dtype)


def _dw_weight(w, dtype):
    """[5, 5, C] taps -> the [C, 1, 5, 5] depthwise kernel in `dtype`."""
    return w.permute(2, 0, 1).unsqueeze(1).to(dtype)


def fused_dw_plain(x, w, scale, offset, stride, act):
    """The plain PyTorch version: the same function as the kernel, as
    separate operations (tfnas_tpu/kernels/fused_dw.py `_reference`)."""
    x1 = _elementwise(x, scale, offset, act).permute(0, 3, 1, 2)
    y = F.conv2d(x1, _dw_weight(w, x.dtype), None, stride, KPAD, 1,
                 x.shape[-1])
    y = y.permute(0, 2, 3, 1).contiguous()
    yf = y.to(stat_dtype(y.dtype))
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def fused_dw_forward(x, w, scale, offset, stride, act):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_dw_cuda(x, w, scale, offset, stride, act)
    if x.device.type == "cpu":
        return fused_dw_plain(x, w, scale, offset, stride, act)
    raise ValueError(f"fused_dw has no version for device {x.device}")


class FusedDwNormAct(torch.autograd.Function):
    """Forward: `fused_dw_forward`. Backward: the hand-written VJP of
    tfnas_tpu/kernels/fused_dw.py `_bwd` — y is saved, the elementwise
    prologue is recomputed under autograd, and both depthwise gradients are
    the convolution's transposes."""

    @staticmethod
    def forward(ctx, x, w, scale, offset, stride, act):
        y, s, q = fused_dw_forward(x, w, scale, offset, stride, act)
        ctx.save_for_backward(x, w, scale, offset, y)
        ctx.stride, ctx.act = stride, act
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, w, scale, offset, y = ctx.saved_tensors
        stride, c = ctx.stride, x.shape[-1]
        # sum(y) and sum(y^2) pull back onto y, cast to y's dtype
        gy_eff = gy + (gs + 2.0 * y.to(stat_dtype(y.dtype)) * gq
                       ).to(y.dtype)
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            sd = scale.detach().requires_grad_()
            od = offset.detach().requires_grad_()
            x1 = _elementwise(xd, sd, od, ctx.act)
        x1n = x1.detach().permute(0, 3, 1, 2)
        g = gy_eff.permute(0, 3, 1, 2)
        wk = _dw_weight(w, x.dtype)
        gx1 = torch.nn.grad.conv2d_input(x1n.shape, wk, g, stride, KPAD, 1, c)
        gw = torch.nn.grad.conv2d_weight(x1n, wk.shape, g, stride, KPAD, 1, c)
        gx, gscale, goffset = torch.autograd.grad(
            x1, (xd, sd, od), gx1.permute(0, 2, 3, 1))
        gw = gw[:, 0].permute(1, 2, 0).to(w.dtype)
        return gx, gw, gscale, goffset, None, None


def fused_dw_norm_act(x, w, scale, offset, stride, act):
    """(y, sum(y), sum(y^2)) of y = depthwise5x5(act(x * scale + offset)).

    x: [N, H, W, C] contiguous; w: [5, 5, C] taps; scale, offset: [C]
    folded BN-normalise (+ width mask) parameters, f32."""
    return FusedDwNormAct.apply(x, w.contiguous(), scale.contiguous(),
                                offset.contiguous(), stride, act)


def fold_bn_mask(mean, var, mask=None, eps=1e-5):
    """(scale, offset) with x * scale + offset ==
    mask * (x - mean) * rsqrt(var + eps)."""
    inv = torch.rsqrt(var + eps)
    if mask is not None:
        inv = inv * mask.to(inv.dtype)
    return inv, -mean.to(inv.dtype) * inv
