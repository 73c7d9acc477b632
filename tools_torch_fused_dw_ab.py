#!/usr/bin/env python3
"""Time the fused depthwise kernel of this checkout against the one of a
baseline checkout, in turns, on one CUDA card.

    git archive <commit> | tar -x -C build/parent
    python3 tools_torch_fused_dw_ab.py --baseline build/parent

For every (H, C, stride, act) of the search's soft and sampled sites at
batch 32, bf16, it prints one JSON line with both kernels' times taken in
the order baseline, this, this, baseline: `device_ms` (CUDA events around
the replay of a CUDA graph of 20 calls), `ms` (events around 20
back-to-back Python calls, host included) and `host_us` (host clock per
call, enqueue only), each as a list of the two turns, and the site's
bound. The baseline's wrapper is imported from its
own checkout under another package name, and builds its kernel there.
The last line sums each version's device time over the 18 soft and the
18 sampled launches of one forward (the site counts of
`supernet.block_sites`).
"""

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from tfnas_tpu_torch.kernels import fused_dw
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import block_sites


def load_baseline(root):
    """The baseline checkout's tfnas_tpu_torch, imported as a package of
    another name so both versions live in one process."""
    name = "baseline_tfnas_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "tfnas_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels.fused_dw")


def site_counts():
    """Launches of one forward at each (H, C, stride): soft and sampled."""
    counts = collections.Counter()
    for site in block_sites(tss):
        h = tss.BLOCK_INPUT_RES[site.stage][int(site.block[5:]) - 1]
        counts[(h, 48 * site.ic, site.stride)] += 1
        counts[(h, 8 * site.ic, site.stride)] += 1
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the baseline checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    base = load_baseline(args.baseline)
    versions = {"baseline": base, "this": fused_dw}
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device="cuda")
    counts = site_counts()
    totals = collections.defaultdict(float)
    for h, c, stride, act, path in cs.main_path_sites(tss):
        x, w, scale, offset = cs._inputs(torch, gen, h, c, torch.bfloat16)
        row = {"h": h, "c": c, "stride": stride, "act": act, "path": path,
               "bound_ms": cs._bound(x, w, stride)[0],
               "per_forward": counts[(h, c, stride)]}
        with torch.no_grad():
            for ver in ("baseline", "this", "this", "baseline"):
                mod = versions[ver]

                def fn():
                    return mod.fused_dw_cuda(x, w, scale, offset, stride,
                                             act)
                ms = cs._timed(torch, fn)
                dev, _, host_us = cs._timings(torch, fn, flush)
                row.setdefault(f"{ver}_ms", []).append(ms)
                row.setdefault(f"{ver}_device_ms", []).append(dev)
                row.setdefault(f"{ver}_host_us", []).append(host_us)
        for ver in versions:
            dev = row[f"{ver}_device_ms"]
            totals[(ver, path)] += row["per_forward"] * sum(dev) / len(dev)
        print(json.dumps(row), flush=True)
        del x
    print(json.dumps({"per_forward_device_ms": {
        f"{ver} {path}": t for (ver, path), t in sorted(totals.items())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
