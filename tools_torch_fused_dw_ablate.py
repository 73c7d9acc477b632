#!/usr/bin/env python3
"""Where the fused depthwise kernel's time goes: time it with one part of
its work taken out, on one CUDA card.

    python3 tools_torch_fused_dw_ablate.py

Each ablation is a copy of tfnas_tpu_torch/csrc/fused_dw.cu with one part
replaced (the results are wrong on purpose; only the times are read):

- none: the kernel as it is;
- no_activation: rows are copied but not activated (the math reads raw x);
- no_math: rows are copied and activated, no tap is read and no FMA done;
- no_copy: no cp.async is issued (the ring holds stale data);
- no_barrier: the one __syncthreads per input row is dropped.

Every copy is built like the kernel (into build/tfnas_tpu_torch/, by
source hash) and timed at bf16, batch 32, at the soft sites of 56^2 and
above: device ms per launch from events around a CUDA-graph replay of 20
launches (chip_smoke.py `_timings`). One JSON line per (ablation, site),
after one line per ablation with ptxas's registers and spill bytes for each
of the kernel's instantiations.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from tfnas_tpu_torch.kernels import fused_dw
from tfnas_tpu_torch.models import search_space as tss

ABLATIONS = {
    "none": [],
    "no_activation": [("          if (in_img) {\n            switch (act)",
                       "          if (false) {\n            switch (act)")],
    "no_math": [("if (in_img && cols_live) {", "if (false) {")],
    "no_copy": [("if (iy >= 0 && iy < H && chunk_live) {", "if (false) {")],
    "no_barrier": [("__syncthreads();  // row k activated", "//")],
}


def ptxas_summary(log):
    """[(instantiation, registers, spill store bytes, spill load bytes)]"""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = re.search(r"fused_dw_kernelI(.*)EEv", name)
            out.append((short.group(1) if short else name, int(m.group(1)))
                       + spill)
            name = None
    return out


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    source = fused_dw._SOURCE.read_text()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device="cuda")
    sites = [s for s in cs.main_path_sites(tss)
             if s[4] == "soft" and s[0] >= 56]
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in ABLATIONS.items():
            text = source
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"{name}: the source has no {old!r}")
                text = text.replace(old, new)
            path = Path(tmp) / f"fused_dw_{name}.cu"
            path.write_text(text)
            fused_dw._SOURCE, fused_dw._lib = path, None
            fused_dw.build_library()
            print(json.dumps({"ablation": name, "ptxas": ptxas_summary(
                fused_dw.build_info["log"])}), flush=True)
            for h, c, stride, act, _ in sites:
                x, w, scale, offset = cs._inputs(torch, gen, h, c,
                                                 torch.bfloat16)
                with torch.no_grad():
                    dev = cs._timings(torch, lambda: fused_dw.fused_dw_cuda(
                        x, w, scale, offset, stride, act), flush)[0]
                print(json.dumps({"ablation": name, "h": h, "c": c,
                                  "stride": stride, "act": act,
                                  "device_ms": dev,
                                  "bound_ms": cs._bound(x, w, stride)[0]}),
                      flush=True)
                del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
