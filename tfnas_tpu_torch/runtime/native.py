"""ctypes bindings for the C++ image pipeline (the port's own copy of
tfnas_tpu/runtime/native.py).

`src/image_pipeline.cpp` does libjpeg decode and the fused augment (crop
box resize, flip, colour jitter, quantise to uint8) of a whole batch in one
call; the random draws stay in Python (data/transforms.py). The library
is built with g++ at first use into `build/tfnas_tpu_torch/`, once per
source content, and a failed build raises: there is no fallback to another
decoder when the compiler or libjpeg is missing. Entries that libjpeg
cannot decode (non-JPEG or corrupt files) come back with a non-zero status
for the caller's PIL path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "src" / "image_pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tfnas_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
# identity normalisation: the pipeline's float entries produce [0, 1] pixels
_ZERO3 = np.zeros((3,), np.float32)
_ONE3 = np.ones((3,), np.float32)


def build_library():
    """Compile the pipeline into BUILD_DIR (once per source content and
    flags) and return its path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtfnas_data_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SOURCE),
                           "-ljpeg"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        u8pp = ctypes.POINTER(u8p)
        szp = ctypes.POINTER(ctypes.c_size_t)
        i = ctypes.c_int
        lib.tfnas_augment_val.restype = i
        lib.tfnas_augment_val.argtypes = [u8p, i, i, i, i, f32p, f32p, f32p]
        lib.tfnas_augment_train.restype = i
        lib.tfnas_augment_train.argtypes = [
            u8p, i, i, i, i, i, i, i, i, i32p, f32p, f32p, f32p, f32p]
        lib.tfnas_decode_augment_train_batch_u8.restype = i
        lib.tfnas_decode_augment_train_batch_u8.argtypes = [
            u8pp, szp, i, i32p, i, i32p, i32p, f32p, u8p, i32p, i]
        lib.tfnas_decode_augment_val_batch_u8.restype = i
        lib.tfnas_decode_augment_val_batch_u8.argtypes = [
            u8pp, szp, i, i, i, u8p, i32p, i]
        _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _ptr_array(datas):
    """(uint8** array, size_t* array, the buffers they point into) for a
    list of bytes objects; the buffers must outlive the call."""
    n = len(datas)
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[_ptr(b, ctypes.c_uint8) for b in bufs])
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    return ptrs, lens, bufs


def native_threads():
    """C++ worker threads inside one batch call (TFNAS_NATIVE_THREADS,
    default 1: the DataLoader's threads work on batches in parallel)."""
    return int(os.environ.get("TFNAS_NATIVE_THREADS", "1"))


def _train_args(n, boxes, flips, orders, factors):
    boxes = np.ascontiguousarray(boxes, np.int32).reshape(n, 4)
    flips = np.ascontiguousarray(flips, np.int32)
    orders_arr = np.full((n, 4), -1, np.int32)
    for j, o in enumerate(orders):
        orders_arr[j, :len(o)] = o
    factors = np.ascontiguousarray(factors, np.float32)
    return boxes, flips, orders_arr, factors


def decode_augment_train_batch_u8(datas, boxes, out_size, flips, orders,
                                  factors):
    """Decode + train augment a batch in one C call, as uint8 pixels
    rint(x * 255) for normalisation on the card. Returns (out [n, S, S, 3]
    uint8, status [n] int32; status != 0 marks the entries for the PIL
    path)."""
    lib = _load()
    n = len(datas)
    ptrs, lens, bufs = _ptr_array(datas)
    boxes, flips, orders_arr, factors = _train_args(n, boxes, flips, orders,
                                                    factors)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    lib.tfnas_decode_augment_train_batch_u8(
        ptrs, lens, n, _ptr(boxes, ctypes.c_int), out_size,
        _ptr(flips, ctypes.c_int), _ptr(orders_arr, ctypes.c_int),
        _ptr(factors, ctypes.c_float), _ptr(out, ctypes.c_uint8),
        _ptr(status, ctypes.c_int), native_threads())
    del bufs
    return out, status


def decode_augment_val_batch_u8(datas, resize, crop):
    """Decode + resize + centre crop a batch in one C call, as uint8
    pixels. Returns (out [n, crop, crop, 3] uint8, status [n] int32)."""
    lib = _load()
    n = len(datas)
    ptrs, lens, bufs = _ptr_array(datas)
    out = np.empty((n, crop, crop, 3), np.uint8)
    status = np.empty((n,), np.int32)
    lib.tfnas_decode_augment_val_batch_u8(
        ptrs, lens, n, resize, crop, _ptr(out, ctypes.c_uint8),
        _ptr(status, ctypes.c_int), native_threads())
    del bufs
    return out, status


def augment_train_from_array(img, crop_box, out_size, flip, order,
                             factors):
    """The train augment on a decoded uint8 [H, W, 3] image (the PIL path's
    pixels), as float [0, 1] pixels."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((out_size, out_size, 3), np.float32)
    order = np.asarray(list(order) + [-1] * (4 - len(order)), np.int32)
    factors = np.asarray(factors, np.float32)
    cx, cy, cw, ch = crop_box
    rc = lib.tfnas_augment_train(
        _ptr(img, ctypes.c_uint8), w, h, cx, cy, cw, ch, out_size, int(flip),
        _ptr(order, ctypes.c_int), _ptr(factors, ctypes.c_float),
        _ptr(_ZERO3, ctypes.c_float), _ptr(_ONE3, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"native augment failed (rc={rc})")
    return out


def augment_val(img, resize, crop):
    """The val transform (resize the short side, centre crop) on a decoded
    uint8 [H, W, 3] image, as float [0, 1] pixels."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((crop, crop, 3), np.float32)
    rc = lib.tfnas_augment_val(
        _ptr(img, ctypes.c_uint8), w, h, resize, crop,
        _ptr(_ZERO3, ctypes.c_float), _ptr(_ONE3, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"native val augment failed (rc={rc})")
    return out
