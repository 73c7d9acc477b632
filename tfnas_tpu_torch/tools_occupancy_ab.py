"""How far one card fills as the search batch grows (counterpart of the
repository's tools_occupancy_ab.py): weight steps per second and images
per second of bench.py's search schedule (a bi-sampling weight step every
iteration, a soft arch step every second one; 224^2, 100 classes, bf16 on
the card) at each batch size, everything else fixed.

    python -m tfnas_tpu_torch.tools_occupancy_ab [--batches 32,64,128,256]
        [--n_timed 24] [--warm 6] [--remat_blocks] [--eager] [--json_out F]

One process, two rounds over the batch sizes; only round 2 is reported.
Each pass builds its supernet state and, on the card, its CUDA graphs
(captured during the `warm` iterations, as the compiled search replays
its steps; --eager runs the steps eagerly) and frees them at its end,
since a graph holds its memory pool: round 1 pays the captures and the
first-use caches (cuDNN's choices, the kernel build), round 2 runs warm.
--remat_blocks passes the JAX net's option of that name to SuperNetwork
(each block's forward is recomputed in the backward). Each row carries the
pass's peak allocated and reserved memory. A batch that does not fit
raises, as the JAX tool does: --batches picks what runs.

The last line is one JSON object: the rows, the fused kernel's launches by
stride over all passes (eager launches, nodes recorded at capture and
nodes run by replays), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

from .device import describe, resolve_device
from .kernels import fused_dw
from .models import search_space as ss
from .search.compiled import GraphFamily
from .tools_setup import ROOT, search_rate, search_setup


def release(device):
    """Free the card memory of graphs and buffers no longer referenced."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def one_pass(device, space, batch, args, lut_path):
    """(weight steps/s, peak allocated GB, peak reserved GB) of one pass."""
    release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    net, state, target, gen = search_setup(
        device, space, batch, args.image_size, args.num_classes, lut_path,
        remat_blocks=args.remat_blocks)
    family = (GraphFamily(device)
              if device.type == "cuda" and not args.eager else None)
    rate = search_rate(net, state, target, gen, family, args.n_timed,
                       args.warm)
    peak = reserved = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        reserved = torch.cuda.max_memory_reserved(device) / 1e9
    del net, state, family
    release(device)
    return rate, peak, reserved


parser = argparse.ArgumentParser("search occupancy ablation")
parser.add_argument("--batches", type=str, default="32,64,128,256")
parser.add_argument("--n_timed", type=int, default=24)
parser.add_argument("--warm", type=int, default=6)
parser.add_argument("--json_out", type=str, default="")
parser.add_argument("--remat_blocks", action="store_true")
parser.add_argument("--eager", action="store_true")
parser.add_argument("--device", type=str, default="cuda")
parser.add_argument("--space", choices=["mbconv", "tiny"], default="mbconv")
parser.add_argument("--image_size", type=int, default=224)
parser.add_argument("--num_classes", type=int, default=100)


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    space = (ss.tiny_space(args.image_size) if args.space == "tiny"
             else None)
    lut_path = os.path.join(ROOT, "latency_pkl", "latency_tpu_v5e_bs32.pkl")
    batches = [int(b) for b in args.batches.split(",")]
    fused_dw.reset_launches()
    results = {}
    for rnd in (1, 2):
        for bs in batches:
            rate, peak, reserved = one_pass(device, space, bs, args,
                                            lut_path)
            print(f"# round {rnd} bs {bs}: {rate:.3f} steps/s "
                  f"({rate * bs:.0f} img/s), peak {peak} GB",
                  file=sys.stderr, flush=True)
            if rnd == 2:  # the warm pass
                results[bs] = (rate, peak, reserved)

    base = results[batches[0]][0] * batches[0]
    rows = [{"batch": bs, "steps_per_sec": r, "images_per_sec": r * bs,
             "throughput_vs_bs32": r * bs / base, "peak_GB": peak,
             "reserved_GB": reserved}
            for bs, (r, peak, reserved) in results.items()]
    out = {"metric": "search_occupancy_ablation", "rows": rows,
           "tool": "tools_occupancy_ab",
           "mode": ("captured" if device.type == "cuda" and not args.eager
                    else "eager"),
           "remat_blocks": args.remat_blocks, "space": args.space,
           "image_size": args.image_size, "n_timed": args.n_timed,
           "warm": args.warm, "fused_dw": fused_dw.launch_counts(),
           **describe(device)}
    line = json.dumps(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    print("batch  steps/s  img/s   x-vs-first  peak GB", file=sys.stderr)
    for row in rows:
        print(f"{row['batch']:>5}  {row['steps_per_sec']:>7.3f}  "
              f"{row['images_per_sec']:>6.0f}  "
              f"{row['throughput_vs_bs32']:>5.2f}  {row['peak_GB']}",
              file=sys.stderr)
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
