"""ctypes bindings for the C++ image pipeline (the port's own copy of
tfnas_tpu/runtime/native.py).

`src/image_pipeline.cpp` does libjpeg decode and the fused augment (crop
box resize, flip, colour jitter, quantise to uint8) of a whole batch in one
call; the random draws stay in Python (data/transforms.py). The library
is built with g++ at first use into `build/tfnas_tpu_torch/`, once per
source content. `available()` says whether it built and loaded here: it is
false when g++ or libjpeg's header is missing or the build fails, and
`build_error` then holds why; data.ImageList decodes with PIL instead.
`build_library()` called directly raises on a failed build. Entries that
libjpeg cannot decode (non-JPEG or corrupt files) come back with a non-zero
status for the caller's PIL path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from ..kernels import nvcc

_SOURCE = Path(__file__).resolve().parent / "src" / "image_pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tfnas_tpu_torch"
GXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
# why the library could not be built or loaded, once that was tried
build_error = None
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
    proc = subprocess.run([GXX, *GXX_FLAGS, "-o", str(tmp), str(_SOURCE),
                           "-ljpeg"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        first = next((l.strip() for l in proc.stderr.splitlines()
                      if "error" in l), "")
        raise RuntimeError(
            f"{GXX} failed on {_SOURCE.name}: {first}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_u8p, _f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_i32p, _i = ctypes.POINTER(ctypes.c_int), ctypes.c_int
# the C interface of src/image_pipeline.cpp
SIGNATURES = {
    "tfnas_augment_val": ([_u8p, _i, _i, _i, _i, _f32p, _f32p, _f32p], _i),
    "tfnas_augment_train": ([_u8p, _i, _i, _i, _i, _i, _i, _i, _i, _i32p,
                             _f32p, _f32p, _f32p, _f32p], _i),
    "tfnas_decode_augment_train_batch_u8": (
        [ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t), _i, _i32p,
         _i, _i32p, _i32p, _f32p, _u8p, _i32p, _i], _i),
    "tfnas_decode_augment_val_batch_u8": (
        [ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t), _i, _i, _i,
         _u8p, _i32p, _i], _i)}


def _load():
    return nvcc.load(sys.modules[__name__], SIGNATURES)


def available():
    """Whether the C++ pipeline is built and loaded here (built at the
    first call); when false, `build_error` says why."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


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
