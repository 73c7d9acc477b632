"""The port's native libraries and their kernels' launch counters.

A CUDA source with a plain C interface is compiled by the toolkit's nvcc
for sm_90a into a shared library under `build/tfnas_tpu_torch/`, once per
source content and flags (`build`, `build_library`). `load` opens a
library with ctypes for the module that owns it (kernels/fused_dw.py,
kernels/bias_act.py, runtime/card.py, and runtime/native.py's g++ build)
and keeps it, or the reason it failed, in that module. Nothing is built at
import: the CPU tests import every module, and the CPU machine has no
nvcc.

`LaunchCounter` counts a kernel's launches and registers itself in
utils/trace.py's `launch_counters` by kernel name, for search/compiled.py
to read at each capture and add to at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..utils import trace

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tfnas_tpu_torch"
SM90A_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def cuda_home():
    """The CUDA toolkit's root: CUDA_HOME, else /usr/local/cuda."""
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = cuda_home() / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA sources are built "
                       "with the CUDA toolkit's nvcc on the machine with "
                       "the card")


def build(source, stem, flags, libs=()):
    """Compile `source` into `<BUILD_DIR>/<stem>_<hash>.so` unless it is
    there; returns {"path", "seconds", "log"} (nvcc's stderr: ptxas's
    registers and spills). Raises RuntimeError when nvcc fails."""
    src = Path(source)
    tag = hashlib.sha256(src.read_bytes() + " ".join(
        (*flags, *libs)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}_{tag}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": "cached"}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": proc.stderr.strip()}


def build_library(owner, stem, libs=()):
    """Compile `owner._SOURCE` (owner: the module that owns a library) into
    `<BUILD_DIR>/<stem>_<hash>.so` unless it is there, keep `build`'s
    result as `owner.build_info` and return the library's path."""
    owner.build_info = build(owner._SOURCE, stem, SM90A_FLAGS, libs)
    return Path(owner.build_info["path"])


_lock = threading.Lock()


def load(owner, signatures):
    """The ctypes library of `owner`, a module with `build_library()`,
    `_lib` and `build_error`: built and opened at the first call, with
    `signatures` ({function: (argtypes, restype)}) set, and kept as
    `owner._lib`. A build or load that fails is kept as
    `owner.build_error` ("<exception type>: <message>") and raised as a
    RuntimeError, then and at every later call, without a second try."""
    lib = owner._lib
    if lib is not None:
        return lib
    with _lock:
        if owner._lib is None:
            if owner.build_error is not None:
                raise RuntimeError(owner.build_error)
            try:
                lib = ctypes.CDLL(str(owner.build_library()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                owner.build_error = f"{type(e).__name__}: {e}"
                raise RuntimeError(owner.build_error) from e
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            owner._lib = lib
        return owner._lib


class LaunchCounter:
    """A kernel's launches by key (fused_dw: the stride) since it was made
    or reset: `launches`, the eager launches; `captured`, the kernel nodes
    recorded into CUDA graphs instead, on a stream under capture;
    `replayed`, the nodes that replays of captured graphs ran
    (search/compiled.py adds a graph's nodes at each of its replays).
    Registered as `trace.launch_counters[name]`."""

    def __init__(self, name, keys):
        self.launches, self.captured, self.replayed = (
            dict.fromkeys(keys, 0) for _ in range(3))
        trace.launch_counters[name] = self

    def count(self, key):
        """One launch at `key`: a node when the stream is being captured."""
        (self.captured if torch.cuda.is_current_stream_capturing()
         else self.launches)[key] += 1

    def reset(self):
        for counts in (self.launches, self.captured, self.replayed):
            for key in counts:
                counts[key] = 0

    def counts(self):
        return {"launches": dict(self.launches),
                "captured_nodes": dict(self.captured),
                "replayed_nodes": dict(self.replayed)}
