"""The port's CUDA builds: one source with a plain C interface, compiled by
the toolkit's nvcc for sm_90a into a shared library under
`build/tfnas_tpu_torch/`, once per source content and flags, and loaded
with ctypes by the module that owns it (kernels/fused_dw.py,
runtime/card.py). Nothing is built at import: the CPU tests import every
module, and this machine has no nvcc."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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


def build(source, stem, flags, libs=(), build_dir=BUILD_DIR):
    """Compile `source` into `<build_dir>/<stem>_<hash>.so` unless it is
    there; returns {"path", "seconds", "log"} (nvcc's stderr: ptxas's
    registers and spills). Raises RuntimeError when nvcc fails."""
    src = Path(source)
    tag = hashlib.sha256(src.read_bytes() + " ".join(
        (*flags, *libs)).encode()).hexdigest()[:16]
    out = Path(build_dir) / f"{stem}_{tag}.so"
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
