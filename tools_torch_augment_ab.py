#!/usr/bin/env python3
"""Time the card's augment kernel (csrc/image_decode.cu, runtime/card.py)
of this checkout, and of baseline checkouts when they are given, in
turns, on one CUDA card, on real JPEGs decoded by nvJPEG.

    python dataset/make_proxy_dataset.py --out_root DIR ...
    git archive <commit> | tar -x -C build/parent      # optional
    python3 tools_torch_augment_ab.py --img_root DIR \\
        --list DIR/proxy_train.txt [--baseline build/parent[,DIR2]] \\
        [--batches 32,256] [--size 224]

The first max(--batches) entries of the list are decoded once with this
checkout's nvJPEG path, and the train draws are made as chip_smoke.py's
decode phase makes them (numpy seed 0: crop box, flip, jitter order and
factors); a batch larger than the list repeats its images. For each batch
and mode (train, val) it prints one JSON line: for each version, its
uint8 error against this checkout's plain version on the same inputs
(max levels, unequal share) and whether a rerun is bit-identical, once;
then, in the turns baselines, this, this, baselines in reverse (this,
this without a baseline), `device_ms` (CUDA events around 5 calls
queued behind a spin kernel: the device work of a call, argument copies
included where a version makes them), `kernel_ms` (torch.profiler: the device time of the
calls' kernels named augment*, per call, and how many such kernels a
call launched) and `host_ms` (host clock per call, enqueue only); and
the augment's bound (chip_smoke._augment_bound). The first lines give
the card's name and power limit, nvcc's version and each library's
ptxas log.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from tfnas_tpu_torch.kernels import nvcc
from tfnas_tpu_torch.runtime import card

PROFILED_CALLS = 5


def load_baseline(root, name):
    """The baseline checkout's runtime/card.py, imported as package `name`
    so that every version lives in one process (each builds its library
    in its own checkout)."""
    pkg = os.path.join(os.path.abspath(root), "tfnas_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.runtime.card")


def draws(images, rng):
    """chip_smoke.phase_decode's train draws for `images`."""
    from tfnas_tpu_torch.data.transforms import sample_jitter, sample_rrc_box
    boxes, flips, orders, factors = [], [], [], []
    for img in images:
        h, w = img.shape[:2]
        boxes.append(sample_rrc_box(w, h, rng))
        flips.append(rng.random() < 0.5)
        order, facs = sample_jitter(rng)
        orders.append(order)
        factors.append(facs)
    return boxes, flips, orders, factors


def kernel_ms(fn):
    """(device ms, kernel launches) per call of the kernels named
    augment*, from torch.profiler; (None, 0) where it recorded none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if "augment" in e.key]
    if not found:
        return None, 0
    us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
             for e in found)
    return (us / 1e3 / PROFILED_CALLS,
            sum(e.count for e in found) / PROFILED_CALLS)


def check(mod, call, want):
    got = call()
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    return {"max_abs_err": int(d.max()),
            "unequal_share": float((d > 0).float().mean()),
            "bit_identical_rerun": bool(torch.equal(call(), got))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img_root", required=True)
    ap.add_argument("--list", dest="list_path", required=True)
    ap.add_argument("--baseline", default="",
                    help="roots of baseline checkouts, comma-separated")
    ap.add_argument("--batches", default="32,256")
    ap.add_argument("--size", type=int, default=224)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    version = subprocess.run([nvcc.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    bases = [r for r in args.baseline.split(",") if r]
    versions = {"this": card}
    for i, root in enumerate(bases):
        versions[f"baseline{i}"] = load_baseline(
            root, f"baseline{i}_tfnas_tpu_torch")
    for name, mod in versions.items():
        mod.build_library()
    print(json.dumps({"nvidia_smi": smi, "nvcc": version.splitlines()[-1],
                      "baselines": {f"baseline{i}": r
                                    for i, r in enumerate(bases)},
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "ptxas": {n: m.build_info["log"][-1500:]
                                for n, m in versions.items()}}), flush=True)
    dev = torch.device("cuda")
    batches = [int(b) for b in args.batches.split(",")]
    with open(args.list_path) as f:
        entries = [l.split()[0] for l in f if l.strip()]
    datas = []
    for rel in entries[:max(batches)]:
        with open(os.path.join(args.img_root, rel), "rb") as f:
            datas.append(f.read())
    decoded, backends = card.decode_batch(datas, dev)
    if "refused" in backends:
        raise SystemExit("nvJPEG refused an entry of the list")
    names = [f"baseline{i}" for i in range(len(bases))]
    turns = names + ["this", "this"] + names[::-1]
    size = args.size
    for n in batches:
        images = (decoded * -(-n // len(decoded)))[:n]
        boxes, flips, orders, factors = draws(images, np.random.default_rng(0))
        for mode in ("train", "val"):
            calls = {}
            for name, mod in versions.items():
                if mode == "train":
                    calls[name] = (lambda m=mod: m.augment_train(
                        images, boxes, size, flips, orders, factors))
                else:
                    calls[name] = lambda m=mod: m.augment_val(images, size)
            if mode == "train":
                want = torch.stack([card.quantize_plain(
                    card.augment_train_plain(img, boxes[i], size, flips[i],
                                             orders[i], factors[i]))
                    for i, img in enumerate(images)])
                bound = cs._augment_bound(card, images, size, boxes, orders)
            else:
                want = torch.stack([card.quantize_plain(
                    card.augment_val_plain(img, size)) for img in images])
                bound = cs._augment_bound(card, images, size)
            row = {"n": n, "size": size, "mode": mode,
                   "bound_ms": bound[0], "bound_by": bound[1]}
            for name, mod in versions.items():
                row[f"{name}_check"] = check(mod, calls[name], want)
                if "augment_kernels" in mod.launches:  # this checkout's
                    before = mod.launches["augment_kernels"]
                    calls[name]()
                    row[f"{name}_kernel_launches_per_call"] = \
                        mod.launches["augment_kernels"] - before
            for name in turns:
                fn = calls[name]
                row.setdefault(f"{name}_device_ms", []).append(
                    cs._queued_ms(torch, fn))
                ms, launched = kernel_ms(fn)
                row.setdefault(f"{name}_kernel_ms", []).append(ms)
                row.setdefault(f"{name}_kernels_per_call", []).append(
                    launched)
                row.setdefault(f"{name}_host_ms", []).append(
                    cs._host_ms(torch, fn))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
