"""The image pipeline on the card: nvJPEG decode and the hand-written fused
augment kernel (`csrc/image_decode.cu`), the port's counterpart of the C++
pipeline `runtime/native.py` + `src/image_pipeline.cpp` for lists that
feed a CUDA device.

A batch goes: the random draws in Python (data/imagelist.py, as the native
path takes them) -> `tfnas_card_probe` (each entry's size and backend, on
the host) -> one torch-allocated device buffer laid out by `decode_layout`
-> `tfnas_card_decode` (nvJPEG's hardware backend for what it supports,
its default backend for the rest) -> `augment_train` / `augment_val` (the
kernel) -> uint8 [n, S, S, 3] on the card. Entries nvJPEG refuses (not a
JPEG, CMYK, truncated) come back with a non-zero status; the caller's
host decode (PIL) gives their pixels, which are uploaded and go through
the same kernel. Each DataLoader thread borrows a worker: its own nvJPEG
decode states and CUDA stream (the only stream it synchronises). The
augment's per-image arguments travel in its launch's parameters: a call
copies nothing to the card before it.

The library is built with nvcc at first use into `build/tfnas_tpu_torch/`
(kernels/nvcc.py) and loads nvJPEG from the CUDA toolkit with dlopen.
`available()` says whether it built and opened here; `build_error` then
says why not. On CPU tensors `augment_train` / `augment_val` run the plain
versions `augment_train_plain` / `augment_val_plain` + `quantize_plain`,
the same arithmetic operation by operation; the CPU tests hold those
against the JAX package's C++ augment, and the card tests and
chip_smoke.py hold the kernel against them. `launches["augment"]` counts
the wrapper's calls that launch the kernel: one launch per call of up to
LAUNCH_IMAGES images (a larger batch, one per LAUNCH_IMAGES). `plan` is
the kernel's decomposition of a call; the kernel checks it and lays out
its work and shared memory the same way.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import math
import sys
import threading
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

from ..kernels import nvcc

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "image_decode.cu"
LIBS = ("-ldl",)
MODE_TRAIN, MODE_VAL = 0, 1
VAL_RESIZE = 256          # the val transform's short side
ALIGN = 256               # bytes: each decoded image's start in the buffer
# csrc/image_decode.cu's constants of the augment kernel
LANES = 32                # a warp: 32 consecutive output columns
MAX_WARPS = 32            # 1024 threads a block
MAX_CLUSTER = 8           # blocks of one image's cluster (portable size)
HOLD = 8                  # pixels a thread holds in registers
LAUNCH_IMAGES = 256       # images whose arguments travel in one launch
TILE_BYTES = 64 << 10     # a sweep's staging buffer, at most
SMEM_PER_BLOCK = 232_448  # the H100's shared memory for one block
ROW_BYTES, COL_BYTES = 24, 12   # sizeof(Row), sizeof(Col)
BACKENDS = ("hardware", "default")
# csrc/image_decode.cu `ImageArgs`, field for field
IMAGE_ARGS = np.dtype([
    ("src", "<i8"), ("row", "<i8"), ("col", "<i8"), ("chan", "<i8"),
    ("h", "<i4"), ("w", "<i4"), ("ox", "<i4"), ("oy", "<i4"),
    ("num_x", "<i4"), ("den_x", "<i4"), ("num_y", "<i4"), ("den_y", "<i4"),
    ("flip", "<i4"), ("order", "<i4", (4,)), ("factors", "<f4", (4,))],
    align=True)

# since import (or the last reset): "augment", the wrapper's calls that
# launched the kernel; "augment_kernels", its launches (one per
# LAUNCH_IMAGES images of a call); plain calls count in neither
launches = {"augment": 0, "augment_kernels": 0}
# how the loaded library was obtained: {"path", "seconds", "log"}
build_info = None
# why the library could not be built, loaded or opened, once that was tried
build_error = None
# nvJPEG's version and backends once opened (`open_pipeline`)
info = None
_lib = None
_lock = threading.Lock()
_idle = []   # workers not in use


def reset_launches():
    for key in launches:
        launches[key] = 0


# -- building and opening ------------------------------------------------------

def nvjpeg_path():
    """libnvjpeg's file in the CUDA toolkit: libnvjpeg.so where the
    link-time symlink is there, else the highest libnvjpeg.so.N."""
    home = nvcc.cuda_home()
    dirs = [home / "lib64", home / "targets" / "x86_64-linux" / "lib",
            home / "lib"]
    for d in dirs:
        if (d / "libnvjpeg.so").exists():
            return d / "libnvjpeg.so"
        found = sorted(d.glob("libnvjpeg.so.*"), key=lambda p: [
            int(t) if t.isdigit() else 0 for t in p.name.split(".")[2:]])
        if found:
            return found[-1]
    raise RuntimeError(f"no libnvjpeg.so under {', '.join(map(str, dirs))}")


def build_library():
    """Compile csrc/image_decode.cu into nvcc.BUILD_DIR (once per source
    content and flags) and return its path; raises when nvcc fails."""
    return nvcc.build_library(sys.modules[__name__], "libtfnas_card", LIBS)


_p, _i = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/image_decode.cu
SIGNATURES = {
    "tfnas_card_open": ([ctypes.c_char_p, _i, ctypes.POINTER(_i)], _i),
    "tfnas_card_dlerror": ([], ctypes.c_char_p),
    "tfnas_card_worker": ([ctypes.POINTER(_p)], _i),
    "tfnas_card_probe": ([_p, _p, _p, _i, _p], _i),
    "tfnas_card_decode": ([_p, _p, _p, _i, _p, _p, _p, _p], _i),
    "tfnas_augment": ([_p, _i, _p, _p, _p], _i)}


def _load():
    return nvcc.load(sys.modules[__name__], SIGNATURES)


def open_pipeline(device):
    """Build and load the library, load nvJPEG and create its handles on
    `device` (once per process): {"nvjpeg": version, "hardware": whether
    the hardware backend is there, "hardware_status": nvjpegCreateEx's
    status for it, "hw_planar", "device"}. Raises RuntimeError (with
    build_error) when any of it fails, or for a second device."""
    global info, build_error
    lib = _load()
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _lock:
        if info is None:
            if build_error is not None:
                raise RuntimeError(build_error)
            try:
                path = str(nvjpeg_path())
            except RuntimeError as e:
                build_error = f"RuntimeError: {e}"
                raise
            props = (ctypes.c_int * 7)()
            with torch.cuda.device(index):
                rc = lib.tfnas_card_open(path.encode(), index, props)
            if rc != 0:
                why = (lib.tfnas_card_dlerror().decode() if rc == -1 else
                       f"nvjpegCreateEx(default backend) status {rc - 1000}"
                       if rc >= 1000 else f"cudaSetDevice({index}) failed")
                build_error = f"RuntimeError: nvJPEG ({path}): {why}"
                raise RuntimeError(build_error)
            info = {"nvjpeg": f"{props[0]}.{props[1]}.{props[2]}",
                    "hardware": props[3] == 0,
                    "hardware_status": props[3],
                    "hw_planar": bool(props[4]), "device": props[5],
                    "flags": props[6], "library": path}
        if info["device"] != index:
            raise RuntimeError(f"the card pipeline is open on cuda:"
                               f"{info['device']}, not cuda:{index}")
    return info


def available(device="cuda"):
    """Whether the pipeline builds and opens on `device` here; when false,
    `build_error` says why (or there is no card)."""
    if not torch.cuda.is_available():
        return False
    try:
        open_pipeline(device)
    except RuntimeError:
        return False
    return True


def describe():
    """The decoder line of an opened pipeline, as the drivers log it."""
    if info["hardware"]:
        how = "hardware backend; default backend for what it refuses"
    else:
        how = (f"default backend; no hardware backend: status "
               f"{info['hardware_status']}")
    return f"nvjpeg ({how}; nvJPEG {info['nvjpeg']})"


class _Worker:
    """One loader thread's decode states and stream."""

    def __init__(self, lib, device):
        handle = ctypes.c_void_p()
        rc = lib.tfnas_card_worker(ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"nvJPEG decode state: status {rc - 1000}")
        self.handle = handle
        self.stream = torch.cuda.Stream(device)


@contextlib.contextmanager
def _worker(lib, device):
    with _lock:
        wk = _idle.pop() if _idle else None
    if wk is None:
        wk = _Worker(lib, device)
    try:
        yield wk
    finally:
        with _lock:
            _idle.append(wk)


# -- the launch wrapper's arithmetic (runs without a card) ---------------------

def decode_layout(sizes):
    """(byte offsets, total bytes) of decoded images of (width, height)
    `sizes` back to back in one buffer, each start aligned to ALIGN bytes;
    each takes 3 w h bytes, interleaved or planar."""
    offsets, total = [], 0
    for w, h in sizes:
        offsets.append(total)
        total += -(-3 * int(w) * int(h) // ALIGN) * ALIGN
    return offsets, total


def image_strides(w, h, planar):
    """(row, column, channel) element strides of a decoded [h, w, 3]
    image: planar RGB is three h x w planes, interleaved RGB one 3w-pitched
    image."""
    return (w, 1, w * h) if planar else (3 * w, 3, 1)


Plan = namedtuple("Plan", "size clusters rows warps kx ky hold tile_rows "
                           "buffers smem")


def _align16(x):
    return -(-x // 16) * 16


def plan(size):
    """The augment kernel's decomposition of an S x S output (the same for
    every image and mode): one cluster of `clusters` blocks per image,
    block r owning rows [r * rows, (r + 1) * rows) (the last ones fewer);
    `warps` warps of 32 threads, warp w taking rows w, w + warps, ... and
    lane l columns l, l + 32, ... (`kx` column groups, `ky` row passes).
    `hold`: a thread's kx * ky pixels fit in HOLD registers' worth, so it
    samples each once; else the block sweeps its rows in tiles of
    `tile_rows` (two staging buffers where there are several), sampling
    again after contrast's barrier. `smem`: the block's dynamic shared
    memory (row and column taps, then the staging buffers, each the tile's
    bytes rounded to 16 plus 16 for the span's offset mod 16). Raises
    ValueError where a block's shared memory cannot hold one output row."""
    if size < 1:
        raise ValueError(f"the augment's output size must be >= 1, got "
                         f"{size}")
    rows = -(-size // min(MAX_CLUSTER, size))
    clusters = -(-size // rows)
    kx = -(-size // LANES)
    ky = -(-rows // MAX_WARPS)
    warps = -(-rows // ky)
    hold = kx * ky <= HOLD
    tile_rows = rows
    if not hold and 3 * size * rows > TILE_BYTES:
        tile_rows = max(1, TILE_BYTES // (3 * size))
        if tile_rows >= warps:
            tile_rows -= tile_rows % warps
    buffers = 1 if tile_rows == rows else 2
    smem = (_align16(rows * ROW_BYTES + size * COL_BYTES)
            + buffers * (_align16(3 * size * tile_rows) + 16))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"the augment kernel cannot stage an output of "
                         f"{size} x {size}: {smem} bytes of shared memory")
    return Plan(size, clusters, rows, warps, kx, ky, int(hold), tile_rows,
                buffers, smem)


def plan_ints(p, mode):
    """The kernel's `Plan` struct: 11 int32 in its field order."""
    return np.asarray([p.size, mode, p.clusters, p.rows, p.warps, p.kx,
                       p.ky, p.hold, p.tile_rows, p.buffers, p.smem],
                      np.int32)


def launch_splits(n):
    """(first image, count) of each launch of an n-image call."""
    return [(i, min(LAUNCH_IMAGES, n - i))
            for i in range(0, n, LAUNCH_IMAGES)]


def _lround(x):
    """std::lround for x >= 0: the nearest integer, halves away from 0."""
    f = math.floor(x)
    return int(f + 1 if x - f >= 0.5 else f)


def val_geometry(w, h, size, resize=VAL_RESIZE):
    """(nw, nh, x0, y0): the image resized to short side `resize` and the
    corner of its centre crop of `size`, with image_pipeline.cpp's integer
    arithmetic (lround of the scaled side, C division)."""
    if w < h:
        nw, nh = resize, _lround(h * resize / w)
    else:
        nw, nh = _lround(w * resize / h), resize
    return nw, nh, int((nw - size) / 2), int((nh - size) / 2)


def image_args(images, size, boxes=None, flips=None, orders=None,
               factors=None, resize=VAL_RESIZE, meta=None):
    """The kernel's per-image arguments (IMAGE_ARGS) for uint8 [H, W, 3]
    tensors of any strides: train with `boxes` (x, y, w, h), flips,
    jitter orders and factors; val without. Filled a column at a time;
    `meta`: the images' `_image_meta`, where the caller has it."""
    n = len(images)
    if meta is None:
        meta = _image_meta(images)[1]
    a = np.zeros(n, IMAGE_ARGS)
    h, w = meta[:, 0], meta[:, 1]
    a["h"], a["w"] = h, w
    a["row"], a["col"], a["chan"], a["src"] = meta[:, 3:].T
    if boxes is None:
        a["order"] = -1
        # val_geometry, elementwise: lround of the scaled side, C division
        wide = w >= h
        side = np.where(wide, w * resize, h * resize) / np.where(wide, h, w)
        f = np.floor(side)
        scaled = (f + (side - f >= 0.5)).astype(np.int64)
        nw = np.where(wide, scaled, resize)
        nh = np.where(wide, resize, scaled)
        a["ox"] = np.trunc((nw - size) / 2).astype(np.int64)
        a["oy"] = np.trunc((nh - size) / 2).astype(np.int64)
        a["num_x"], a["den_x"] = w, nw
        a["num_y"], a["den_y"] = h, nh
    else:
        flat = itertools.chain.from_iterable
        box = np.fromiter(flat(boxes), np.int64, 4 * n).reshape(n, 4)
        a["ox"], a["oy"], a["num_x"], a["num_y"] = box.T
        a["den_x"] = a["den_y"] = size
        a["flip"] = np.fromiter(flips, bool, n)
        a["order"] = np.fromiter(flat((*o, -1, -1, -1, -1)[:4]
                                      for o in orders), np.int32,
                                 4 * n).reshape(n, 4)
        a["factors"] = np.fromiter(flat(factors), np.float32,
                                   4 * n).reshape(n, 4)
    return a


# -- the kernel and its plain version ------------------------------------------

def _image_meta(images):
    """(device, int64 [n, 7]: each image's H, W, C, its three element
    strides and its address); raises ValueError unless `images` are uint8
    [H, W, 3] tensors on one device."""
    if not images:
        raise ValueError("the augment needs at least one image")
    dev = images[0].device
    try:
        meta = np.array([(*img.shape, *img.stride(), img.data_ptr())
                         for img in images], np.int64)
        ok = (meta.shape[1] == 7 and (meta[:, 2] == 3).all()
              and (meta[:, :2] >= 1).all())
    except (ValueError, IndexError):  # a tensor of another rank
        ok = False
    if not ok or {(img.dtype, img.device) for img in images} != {
            (torch.uint8, dev)}:
        for img in images:  # the first image that is not right
            if (img.dtype != torch.uint8 or img.dim() != 3
                    or img.shape[2] != 3 or img.device != dev
                    or img.shape[0] < 1 or img.shape[1] < 1):
                raise ValueError(f"images must be uint8 [H, W, 3] tensors "
                                 f"on one device, got {img.dtype} "
                                 f"{tuple(img.shape)} on {img.device}")
    return dev, meta


def _launch(images, mode, size, args):
    p = plan(size)
    lib = _load()
    dev = images[0].device
    out = torch.empty((len(images), size, size, 3), dtype=torch.uint8,
                      device=dev)
    ints = plan_ints(p, mode)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first, count in launch_splits(len(images)):
            rc = lib.tfnas_augment(args[first:].ctypes.data, count,
                                   ints.ctypes.data, out[first].data_ptr(),
                                   stream)
            if rc != 0:
                raise RuntimeError(f"augment kernel launch failed with CUDA "
                                   f"error {rc}")
            launches["augment_kernels"] += 1
    launches["augment"] += 1
    return out


def augment_train(images, boxes, size, flips, orders, factors):
    """uint8 [n, size, size, 3]: the train augment of each uint8 [H, W, 3]
    image (any strides): crop box `boxes[i]` (x, y, w, h) resized to size
    x size, flipped, jittered in `orders[i]` with `factors[i]`, clipped and
    quantised. The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    dev, meta = _image_meta(images)
    if dev.type == "cuda":
        return _launch(images, MODE_TRAIN, size, image_args(
            images, size, boxes, flips, orders, factors, meta=meta))
    if dev.type == "cpu":
        return torch.stack([quantize_plain(augment_train_plain(
            img, boxes[i], size, flips[i], orders[i], factors[i]))
            for i, img in enumerate(images)])
    raise ValueError(f"the augment has no version for device {dev}")


def augment_val(images, size, resize=VAL_RESIZE):
    """uint8 [n, size, size, 3]: each image's short side resized to
    `resize`, the centre size x size crop, quantised. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev, meta = _image_meta(images)
    if dev.type == "cuda":
        return _launch(images, MODE_VAL, size,
                       image_args(images, size, resize=resize, meta=meta))
    if dev.type == "cpu":
        return torch.stack([quantize_plain(augment_val_plain(
            img, size, resize)) for img in images])
    raise ValueError(f"the augment has no version for device {dev}")


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _bilinear_plain(img, sx, sy):
    """image_pipeline.cpp `bilinear` at every (sy[i], sx[j]), scaled to
    [0, 1]: f32 [len(sy), len(sx), 3]."""
    h, w = img.shape[:2]
    sx, sy = sx.clamp(0.0, float(w - 1)), sy.clamp(0.0, float(h - 1))
    x0, y0 = sx.long(), sy.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx = (sx - x0.float())[None, :, None]
    fy = (sy - y0.float())[:, None, None]
    p = img.int()
    p00, p01 = p[y0[:, None], x0[None, :]], p[y0[:, None], x1[None, :]]
    p10, p11 = p[y1[:, None], x0[None, :]], p[y1[:, None], x1[None, :]]
    top = p00.float() + (p01 - p00).float() * fx
    bot = p10.float() + (p11 - p10).float() * fx
    inv = _f32(1.0, img.device) / _f32(255.0, img.device)
    return (top + (bot - top) * fy) * inv


def _gray_plain(x):
    dev = x.device
    return ((_f32(0.299, dev) * x[..., 0] + _f32(0.587, dev) * x[..., 1])
            + _f32(0.114, dev) * x[..., 2])


def _hue_plain(x, shift):
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    v, delta = maxc, maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    dz = delta.clamp(min=1e-12)
    hh = torch.where(maxc == r, torch.fmod((g - b) / dz, 6.0),
                     torch.where(maxc == g, (b - r) / dz + 2.0,
                                 (r - g) / dz + 4.0))
    hh = torch.where(delta == 0, 0.0, hh)
    hh = torch.where(hh < 0, hh + 6.0, hh)
    hn = hh / 6.0 + shift
    hn = hn - torch.floor(hn)
    h6 = hn * 6.0
    ii = (h6.int() % 6).long()
    fr = h6 - torch.floor(h6)
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    pick = [torch.stack(c, -1).gather(-1, ii[..., None])[..., 0] for c in (
        (v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))]
    return torch.stack(pick, -1)


def _jitter_plain(x, op, f):
    if op == 0:
        return x * f
    if op == 1:
        m = (_gray_plain(x).double().sum() / (x.shape[0] * x.shape[1])
             ).float()
        return (x - m) * f + m
    if op == 2:
        g = _gray_plain(x)[..., None]
        return (x - g) * f + g
    return _hue_plain(x, f)


def augment_train_plain(img, box, size, flip, order, factors):
    """The plain version of the train augment of one uint8 [H, W, 3] image,
    as f32 [size, size, 3] in [0, 1] before quantisation:
    image_pipeline.cpp `tfnas_augment_train` step by step (crop-box
    sample, flip, the jitter ops in `order` with no clip between them,
    clip)."""
    dev = img.device
    cx, cy, cw, ch = (int(v) for v in box)
    o = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    sx = (_f32(cx, dev) + o * (_f32(cw, dev) / _f32(size, dev))) - 0.5
    sy = (_f32(cy, dev) + o * (_f32(ch, dev) / _f32(size, dev))) - 0.5
    x = _bilinear_plain(img, sx, sy)
    if flip:
        x = x.flip(1)
    fac = torch.tensor(np.asarray(factors, np.float32), device=dev)
    for op in order:
        x = _jitter_plain(x, op, fac[op])
    return x.clamp(0.0, 1.0)


def augment_val_plain(img, size, resize=VAL_RESIZE):
    """The plain version of the val transform of one uint8 [H, W, 3]
    image (image_pipeline.cpp `tfnas_augment_val`), as f32 [size, size, 3]
    in [0, 1]."""
    dev = img.device
    h, w = img.shape[:2]
    nw, nh, x0, y0 = val_geometry(w, h, size, resize)
    o = torch.arange(size, device=dev)
    sx = ((o + x0).float() + 0.5) * (_f32(w, dev) / _f32(nw, dev)) - 0.5
    sy = ((o + y0).float() + 0.5) * (_f32(h, dev) / _f32(nh, dev)) - 0.5
    return _bilinear_plain(img, sx, sy)


def quantize_plain(x):
    """f32 pixels in [0, 1] -> uint8 rint(x * 255), halves away from 0
    (image_pipeline.cpp `quantize_u8`'s lround)."""
    v = (x * 255.0).clamp(0.0, 255.0)
    return torch.floor(v.double() + 0.5).to(torch.uint8)


# -- a batch through the card --------------------------------------------------

def _ptr_array(datas):
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    ptrs = np.asarray([b.ctypes.data for b in bufs], np.uint64)
    lens = np.asarray([len(d) for d in datas], np.uint64)
    return ptrs, lens, bufs


def _decode(lib, wk, datas, sizes, fallback, device):
    """Decode `datas` into one device buffer on the worker's stream: the
    list of uint8 [H, W, 3] images (views of the buffer, or uploads of
    fallback(i)'s host pixels for the entries nvJPEG refused, or whose size
    is not `sizes[i]`; None there without a fallback), their backends
    ('hardware', 'default', 'pil', or 'refused' without a fallback) and the
    buffer."""
    n = len(datas)
    ptrs, lens, keep = _ptr_array(datas)
    meta = np.zeros((n, 3), np.int32)
    lib.tfnas_card_probe(wk.handle, ptrs.ctypes.data, lens.ctypes.data, n,
                         meta.ctypes.data)
    if sizes is not None:  # the draws took these sizes: keep them
        for i, (w, h) in enumerate(sizes):
            if (meta[i, 0], meta[i, 1]) != (w, h):
                meta[i, 2] = -1
    offsets, total = decode_layout(meta[:, :2].tolist())
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    dst = np.asarray([buf.data_ptr() + o for o in offsets], np.uint64)
    status = np.zeros(n, np.int32)
    rc = lib.tfnas_card_decode(wk.handle, ptrs.ctypes.data, lens.ctypes.data,
                               n, meta.ctypes.data, dst.ctypes.data,
                               status.ctypes.data, wk.stream.cuda_stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"nvJPEG decode failed with CUDA error {rc}")
    images, backends = [], []
    for i in range(n):
        if status[i] == 0:
            w, h, backend = (int(v) for v in meta[i])
            strides = image_strides(w, h, backend == 0 and info["hw_planar"])
            images.append(torch.as_strided(buf, (h, w, 3), strides,
                                           offsets[i]))
            backends.append(BACKENDS[backend])
        elif fallback is None:
            images.append(None)
            backends.append("refused")
        else:
            host = np.array(fallback(i), np.uint8)  # a writable copy
            images.append(torch.from_numpy(host).to(device))
            backends.append("pil")
    return images, backends, buf


@contextlib.contextmanager
def _on_worker(device):
    """A worker of the opened pipeline, its device and stream current; the
    stream is synchronised (and only it) before the worker is handed on."""
    lib = _load()
    open_pipeline(device)
    with torch.cuda.device(device), _worker(lib, device) as wk, \
            torch.cuda.stream(wk.stream):
        yield lib, wk
        wk.stream.synchronize()


def decode_batch(datas, device):
    """nvJPEG's decode of JPEG bytes `datas` on `device`: (uint8 [H, W, 3]
    card tensors, None for the entries it refuses; each entry's backend:
    'hardware', 'default' or 'refused')."""
    with _on_worker(device) as (lib, wk):
        images, backends, _ = _decode(lib, wk, datas, None, None, device)
    return images, backends


def decode_augment_train_batch(datas, sizes, boxes, size, flips, orders,
                               factors, fallback, device):
    """Decode JPEG bytes `datas` with nvJPEG and train-augment them with the
    kernel on `device`: (uint8 [n, size, size, 3] on the card, each
    entry's backend). sizes[i]: the (w, h) the draws were made for;
    fallback(i): host uint8 [H, W, 3] pixels of an entry nvJPEG refuses.
    Synchronises the worker's stream only."""
    with _on_worker(device) as (lib, wk):
        images, backends, buf = _decode(lib, wk, datas, sizes, fallback,
                                        device)
        out = augment_train(images, boxes, size, flips, orders, factors)
    return out, backends


def decode_augment_val_batch(datas, size, fallback, device,
                             resize=VAL_RESIZE):
    """decode_augment_train_batch for the val transform."""
    with _on_worker(device) as (lib, wk):
        images, backends, buf = _decode(lib, wk, datas, None, fallback,
                                        device)
        out = augment_val(images, size, resize)
    return out, backends
