"""The searched-model family table, recomputed from run directories
(counterpart of the repository's tools_family_table.py).

    python -m tfnas_tpu_torch.tools_family_table [--root checkpoints_e2e]
        [--json] [--band LUT_PKL] [--rescore_tag TAG] [--budget_epoch 3]
        [--lookup_path LUT_PKL] [--device cpu]

Walks `<root>/<name>/search-*/model.config` directories that have a
sibling `<root>/<name>-retrain/eval-*/test.txt` (or, with --rescore_tag,
`<name>-rescore-<tag>`), and for each pair reports the search target, the
parsed architecture's LUT latency, FLOPs, parameters and depths per stage,
and the retrained test accuracy (clean, hard@0.5, hard@1.0 and the val
top-1 after --budget_epoch retrain epochs, where those files are there).
Each run's latency table is the one named in the args line of its search
log, as in the JAX tool; --lookup_path names one table for every run (for
a port run: latency_pkl/latency_h100.pkl), and a hybrid-space run takes
its `_hybrid` sibling (latency_h100_hybrid.pkl), which holds the ViT
keys. --band prints the space's
single-path min and max (latency, FLOPs) on a table first. Markdown, or
one JSON line with --json. Its only device work is each net's parameter
init, on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np
import torch

from .cost.flops import calculate_FLOPs_in_M, count_parameters_in_MB
from .cost.lut import load_lat_lookup
from .device import resolve_device
from .models import search_space as ss
from .models.eval_net import EvalNetwork
from .search.parser import get_mc_num_dddict, parse_architecture


def find_pairs(root, rescore_tag=None):
    """Yield (name, search_dir, eval_dir) of completed search + retrain
    pairs; with rescore_tag, `<name>-rescore-<tag>` eval directories are
    paired with <name>'s search directory."""
    suffix = f"-rescore-{rescore_tag}" if rescore_tag else "-retrain"
    for retrain in sorted(glob.glob(os.path.join(root, "*" + suffix))):
        name = os.path.basename(retrain)[: -len(suffix)]
        search_runs = sorted(glob.glob(os.path.join(root, name, "search-*")))
        eval_runs = sorted(glob.glob(os.path.join(retrain, "eval-*")))
        search_runs = [d for d in search_runs
                       if os.path.exists(os.path.join(d, "model.config"))]
        eval_runs = [d for d in eval_runs
                     if os.path.exists(os.path.join(d, "test.txt"))]
        if search_runs and eval_runs:
            yield name, search_runs[-1], eval_runs[-1]


def search_args(search_dir):
    """target_lat, space and lookup_path from the run's args line."""
    with open(os.path.join(search_dir, "log.txt")) as f:
        for line in f:
            if "args = Namespace(" in line:
                def grab(key, default=None):
                    m = re.search(rf"{key}=('[^']*'|[^,)]+)", line)
                    return m.group(1).strip("'") if m else default
                return {"target_lat": float(grab("target_lat", "nan")),
                        "space": grab("space", "mbconv"),
                        "lookup_path": grab("lookup_path", "")}
    return {"target_lat": float("nan"), "space": "?", "lookup_path": ""}


def test_scores(eval_dir, fname="test.txt"):
    top1 = top5 = None
    path = os.path.join(eval_dir, fname)
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Val_acc_top1:\s*([\d.]+)", line)
            if m:
                top1 = float(m.group(1))
            m = re.search(r"Val_acc_top5:\s*([\d.]+)", line)
            if m:
                top5 = float(m.group(1))
    return top1, top5


def budget_score(eval_dir, epoch):
    """Val top-1 after `epoch` + 1 retrain epochs, from the retrain log."""
    path = os.path.join(eval_dir, "log.txt")
    if not os.path.exists(path):
        return None
    seen = []
    with open(path) as f:
        for line in f:
            m = re.search(r"Val_acc_top1:\s*([\d.]+)", line)
            if m:
                seen.append(float(m.group(1)))
    return seen[epoch] if len(seen) > epoch else None


def arch_stats(config_path, lookup_path, num_classes=30, device="cpu"):
    with open(config_path) as f:
        cfg = json.load(f)
    net = EvalNetwork.from_config(num_classes, cfg)
    params, _ = net.init(torch.Generator(device=device).manual_seed(0))
    depths = {k: len(cfg[k]) for k in cfg if k.startswith("stage")}
    has_vit = any(b.get("name") == "ViTBlock"
                  for k in depths for b in cfg[k])
    lat = None
    if lookup_path and os.path.exists(lookup_path):
        lat = net.get_lookup_latency(load_lat_lookup(lookup_path))
    stage_idx = sorted(int(k[len("stage"):]) for k in depths)
    return {"flops_M": round(calculate_FLOPs_in_M(net), 1),
            "params_MB": round(count_parameters_in_MB(params), 2),
            "depths": [depths[f"stage{i}"] for i in stage_idx],
            "has_vit": has_vit,
            "lut_lat_ms": round(lat, 4) if lat is not None else None}


def band_bounds(lookup_path, num_classes=30):
    """(LUT latency, FLOPs) of the cheapest single-path architecture
    (cheapest op, depth 1, least width) and the dearest (dearest op, full
    depth and width) on this table."""
    lut = load_lat_lookup(lookup_path)
    keys = ss.build_lat_lookup_key_dddict()
    masks = ss.build_mc_mask_dddict()

    def entry_lat(k, hi):
        e = lut.get(k)
        if e is None:
            return 0.0 if hi else float("inf")
        return max(e.values()) if hi else min(e.values())

    out = {}
    for name, hi in [("max", True), ("min", False)]:
        ow = []
        for stage in ss.STAGE_NAMES:
            for block in keys[stage]:
                lats = [entry_lat(keys[stage][block][op], hi)
                        for op in range(ss.NUM_OPS)]
                w = np.zeros(ss.NUM_OPS)
                w[int(np.argmax(lats) if hi else np.argmin(lats))] = 1.0
                ow.append(w)
        dw = [np.eye(len(keys[s]))[-1 if hi else 0] for s in ss.STAGE_NAMES]
        net = EvalNetwork.from_parsed_arch(
            num_classes, parse_architecture(ow, dw),
            get_mc_num_dddict(masks, is_max=hi))
        out[name] = {"lut_lat_ms": round(net.get_lookup_latency(lut), 4),
                     "flops_M": round(calculate_FLOPs_in_M(net), 1)}
    return out


parser = argparse.ArgumentParser("family table")
parser.add_argument("--root", default="checkpoints_e2e")
parser.add_argument("--num_classes", type=int, default=30)
parser.add_argument("--json", action="store_true",
                    help="one JSON line instead of markdown")
parser.add_argument("--band", metavar="LUT_PKL", default=None,
                    help="also print the space's single-path min/max "
                         "(latency, FLOPs) on this table")
parser.add_argument("--rescore_tag", default=None,
                    help="pair `<name>-rescore-<tag>` eval dirs with "
                         "<name>'s search dir")
parser.add_argument("--budget_epoch", type=int, default=3,
                    help="also report val top-1 at this 0-based retrain "
                         "epoch")
parser.add_argument("--lookup_path", default=None,
                    help="one latency table for every run, its _hybrid "
                         "sibling for hybrid runs (default: each run's "
                         "own, from its search log)")
parser.add_argument("--device", type=str, default=None,
                    help="default: the card")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.band:
        print(json.dumps({"band": band_bounds(args.band, args.num_classes)}))

    rows = []
    for name, search_dir, eval_dir in find_pairs(args.root,
                                                 args.rescore_tag):
        sa = search_args(search_dir)
        lookup = sa["lookup_path"]
        if args.lookup_path:
            lookup = args.lookup_path
            if sa["space"] == "hybrid":
                lookup = lookup[:-len(".pkl")] + "_hybrid.pkl"
        st = arch_stats(os.path.join(search_dir, "model.config"), lookup,
                        args.num_classes, device)
        top1, top5 = test_scores(eval_dir)
        hard1, hard5 = test_scores(eval_dir, "hardtest.txt")
        h50_1, _ = test_scores(eval_dir, "hardtest_c50.txt")
        rows.append({"name": name, "target_lat": sa["target_lat"],
                     "space": sa["space"], **st,
                     "top1": top1, "top5": top5,
                     "hard_top1": hard1, "hard_top5": hard5,
                     "hard50_top1": h50_1,
                     "budget_top1": budget_score(eval_dir,
                                                 args.budget_epoch),
                     "search_dir": search_dir, "eval_dir": eval_dir})
    rows.sort(key=lambda r: r["flops_M"])
    if args.json:
        print(json.dumps(rows))
        return rows
    have_hard = any(r["hard_top1"] is not None for r in rows)
    have_h50 = any(r["hard50_top1"] is not None for r in rows)
    have_budget = any(r["budget_top1"] is not None for r in rows)
    extra_h = ""
    if have_h50:
        extra_h += " hard@0.5 top-1 |"
    if have_hard:
        extra_h += " hard@1.0 top-1 |"
    if have_budget:
        extra_h += f" ep{args.budget_epoch} top-1 |"
    print("| Run | space | target (ms) | parsed LUT lat (ms) | FLOPs | "
          "params | depths | test top-1 | top-5 |" + extra_h)
    print("|---|---|---|---|---|---|---|---|---|"
          + "---|" * (have_hard + have_h50 + have_budget))

    def fmt(v):
        return "—" if v is None else f"{v:.2f}"

    for r in rows:
        depths = "/".join(str(d) for d in r["depths"])
        space = r["space"] + (" (ViT)" if r["has_vit"] else "")
        lat = ("—" if r["lut_lat_ms"] is None
               else f"{r['lut_lat_ms']:.3f}")
        extra = ""
        if have_h50:
            extra += f" {fmt(r['hard50_top1'])} |"
        if have_hard:
            extra += f" {fmt(r['hard_top1'])} |"
        if have_budget:
            extra += f" {fmt(r['budget_top1'])} |"
        print(f"| {r['name']} | {space} | {r['target_lat']:.2f} | {lat} | "
              f"{r['flops_M']:.1f}M | {r['params_MB']:.2f}MB | {depths} | "
              f"{fmt(r['top1'])} | {fmt(r['top5'])} |" + extra)
    return rows


if __name__ == "__main__":
    main()
