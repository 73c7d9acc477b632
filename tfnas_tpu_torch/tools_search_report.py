"""A search run's convergence evidence from its run directory (counterpart
of the repository's tools_search_report.py).

    python -m tfnas_tpu_torch.tools_search_report --run_dir DIR
        [--space mbconv|hybrid] [--json_out F] [--device cpu]

Reads log.txt and the per-epoch arch_params_NN.pkl (or, where there are
none, searched_model_NN.pkl) dumps, which both packages write alike, and
reports (a) the last logged train loss and accuracy of each epoch, (b) the
mean entropy of exp(alpha) per checkpoint and how many blocks changed
their argmax since the previous one, the ViT candidate's probability
(hybrid space) and the depth betas' softmax per stage, first and last
checkpoint, (c) each epoch's parsed-architecture LUT latency before and
after elasticity against the target, from the log, and (d) the final
checkpoint parsed (search/parser.py) into an EvalNetwork of 1000 classes:
depths, FLOPs, parameters and the nearest TF-NAS FLOPs class.
--lookup_path is accepted as in the JAX tool, which reads the latencies
from the log and not from a table. Its only device work is the parsed
net's parameter init, on the card unless --device cpu. --json_out writes
(a)-(d) as one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import re

import numpy as np
import torch

from .cost.flops import calculate_FLOPs_in_M, count_parameters_in_MB
from .device import resolve_device
from .models.eval_net import EvalNetwork
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)

FLOPS_CLASSES = {"TF-NAS-A": 457, "TF-NAS-B": 361, "TF-NAS-C": 284,
                 "TF-NAS-D": 219}


def parse_log(run_dir):
    """[(epoch, loss, top1)], [[before_lat, after_lat, target]] and the
    val accuracies, from log.txt."""
    epochs, lats, vals = [], [], []
    loss = None
    with open(os.path.join(run_dir, "log.txt")) as f:
        for line in f:
            m = re.search(r"TRAIN.*Objs: ([\d.]+) R1: ([\d.]+)", line)
            if m:
                loss = float(m.group(1))
            m = re.search(r"Train_acc ([\d.]+)", line)
            if m:
                epochs.append((len(epochs), loss, float(m.group(1))))
            m = re.search(
                r"Before, the current lat: ([\d.]+), the target lat: "
                r"([\d.]+)", line)
            if m:
                lats.append([float(m.group(1)), None, float(m.group(2))])
            m = re.search(r"After, the current lat: ([\d.]+)", line)
            if m and lats and lats[-1][1] is None:
                lats[-1][1] = float(m.group(1))
            m = re.search(r"Val_acc ([\d.]+)", line)
            if m:
                vals.append(float(m.group(1)))
    return epochs, lats, vals


def alpha_stats(ckpt_paths):
    """Per checkpoint: (epoch, mean entropy of exp(alpha) in nats, argmax
    per block, softmax of the betas per stage, p(ViT) per block or
    None)."""
    out = []
    for p in ckpt_paths:
        with open(p, "rb") as f:
            ck = pickle.load(f)
        la = np.asarray(ck["arch_params"]["log_alphas"], np.float64)
        prob = np.exp(la)
        prob = prob / prob.sum(-1, keepdims=True)
        ent = -(prob * np.log(np.maximum(prob, 1e-12))).sum(-1).mean()
        betas = {}
        for stage, b in ck["arch_params"]["betas"].items():
            b = np.asarray(b, np.float64)
            e = np.exp(b - b.max())
            betas[stage] = (e / e.sum()).tolist()
        vit = prob[:, 8].tolist() if prob.shape[-1] > 8 else None
        out.append((int(ck["epoch"]), float(ent), prob.argmax(-1).tolist(),
                    betas, vit))
    return out


def final_arch(ckpt_path, device):
    """(parsed arch, FLOPs in M, parameters) of the checkpoint parsed into
    a 1000-class EvalNetwork."""
    op_w, depth_w = get_op_and_depth_weights(ckpt_path)
    parsed = parse_architecture(op_w, depth_w)
    with open(ckpt_path, "rb") as f:
        mc_mask = pickle.load(f)["mc_mask_dddict"]
    net = EvalNetwork.from_parsed_arch(1000, parsed,
                                       get_mc_num_dddict(mc_mask))
    flops = calculate_FLOPs_in_M(net, input_size=224)
    params, _ = net.init(torch.Generator(device=device).manual_seed(0))
    n_params = round(count_parameters_in_MB(params) * 1e6)
    return parsed, flops, n_params


parser = argparse.ArgumentParser("search report")
parser.add_argument("--run_dir", required=True)
parser.add_argument("--lookup_path",
                    default="latency_pkl/latency_tpu_v5e_bs32.pkl")
parser.add_argument("--json_out", default="")
parser.add_argument("--space", default="mbconv", choices=["mbconv", "hybrid"],
                    help="the space the run searched; hybrid only changes "
                         "the uniform-entropy reference (9 ops)")
parser.add_argument("--device", type=str, default=None,
                    help="default: the card")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    run_dir = (glob.glob(args.run_dir)[0] if "*" in args.run_dir
               else args.run_dir)

    epochs, lats, vals = parse_log(run_dir)
    print("== (a) training curve (last logged step per epoch) ==")
    for e, loss, acc in epochs:
        print(f"epoch {e:2d}: loss {loss:.4f}  train_acc {acc:.2f}%")
    if vals:
        print("val_acc (last epochs):", [round(v, 2) for v in vals])

    ckpts = (sorted(glob.glob(os.path.join(run_dir, "arch_params_*.pkl")))
             or sorted(glob.glob(os.path.join(run_dir,
                                              "searched_model_*.pkl"))))
    stats = alpha_stats(ckpts)
    max_ent = float(np.log(9 if args.space == "hybrid" else 8))
    print(f"\n== (b) alpha entropy (uniform = {max_ent:.3f} nats) ==")
    prev_argmax = None
    for ep, ent, am, _, _ in stats:
        flips = (sum(a != b for a, b in zip(am, prev_argmax))
                 if prev_argmax is not None else "-")
        print(f"ckpt epoch {ep:2d}: mean entropy {ent:.4f}  "
              f"argmax flips vs prev: {flips}")
        prev_argmax = am
    print("final argmax ops per block:", stats[-1][2])

    if stats[-1][4] is not None:
        print("\n== (b1) ViT candidate (op 8) trajectory ==")
        for ep, _, am, _, vit in stats:
            elected = sum(a == 8 for a in am)
            print(f"ckpt epoch {ep:2d}: blocks with argmax=ViT: {elected:2d}"
                  f"  mean p(ViT) {np.mean(vit):.4f}"
                  f"  max p(ViT) {np.max(vit):.4f}")
        print("final per-block p(ViT):", [round(v, 3) for v in stats[-1][4]])

    print("\n== (b2) depth betas: softmax per stage (first -> last ckpt) ==")
    first_b, last_b = stats[0][3], stats[-1][3]
    for stage in last_b:
        f = " ".join(f"{v:.2f}" for v in first_b[stage])
        l = " ".join(f"{v:.2f}" for v in last_b[stage])
        am = int(np.argmax(last_b[stage])) + 1
        print(f"{stage}: [{f}] -> [{l}]  parsed depth {am}")
    parsed_depths = [int(np.argmax(last_b[s])) + 1 for s in last_b]
    print(f"stages with parsed depth >= 2: "
          f"{sum(d >= 2 for d in parsed_depths)}/{len(parsed_depths)}")

    print("\n== (c) elasticity: parsed-arch LUT latency vs target ==")
    for i, (before, after, target) in enumerate(lats):
        print(f"epoch {i + len(epochs) - len(lats):2d}: before {before:.4f} "
              f"-> after {after:.4f}  (target {target:.4f}, "
              f"err {abs(after - target) / target * 100:.1f}%)")

    parsed, flops, n_params = final_arch(ckpts[-1], device)
    print("\n== (d) final parsed architecture ==")
    print("parsed depths:", {s: len(parsed[s]) for s in parsed})
    print(f"FLOPs: {flops:.1f}M  params: {n_params / 1e6:.2f}M")
    nearest = min(FLOPS_CLASSES, key=lambda k: abs(FLOPS_CLASSES[k] - flops))
    print(f"nearest reference FLOPs class: {nearest} "
          f"({FLOPS_CLASSES[nearest]}M)")

    report = {
        "train": epochs, "lat": lats, "val": vals,
        "alpha": [(e, ent) for e, ent, _, _, _ in stats],
        "final_argmax": stats[-1][2],
        "betas_first": stats[0][3], "betas_last": stats[-1][3],
        "flops_M": round(flops, 1), "params_M": round(n_params / 1e6, 2),
        "nearest_class": nearest}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.json_out)
    return report


if __name__ == "__main__":
    main()
