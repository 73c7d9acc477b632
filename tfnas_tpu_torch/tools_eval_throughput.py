"""Inference throughput of the eval network, images per second on one card
(counterpart of the repository's tools_eval_throughput.py): the second
baseline metric, "TF-NAS-A eval images/sec/chip".

    python -m tfnas_tpu_torch.tools_eval_throughput [--batches 32,128,...]

TF-NAS-A (configs/tfnas_a_tpu.config, 1000 classes) in eval mode with
BatchNorm folded into the convolutions (models/folding.py), bf16
activations and weights on the card, 224^2, at each batch size: ms per
batch of a chain of --iters dependent forwards (each input's first
element set from the last output's, so no call can be skipped), replayed
from one CUDA graph (cost/measure.py's Chain): the median of 3 timed
chains after a warm-up chain. The reference: TF-NAS-A
takes 18.03 ms at batch 32 on a Titan RTX, 1775 images/s.

One line per batch, then one JSON object: the rows and the card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .cost.measure import measure_latency_in_ms
from .device import describe, resolve_device
from .models.eval_net import EvalNetwork
from .models.folding import fold_batchnorm
from .search.train_step import tree_map
from .tools_setup import ROOT

CONFIG = os.path.join(ROOT, "configs", "tfnas_a_tpu.config")
REFERENCE_IMS = 32 / 0.01803  # TF-NAS-A on a Titan RTX at batch 32

parser = argparse.ArgumentParser("eval throughput")
parser.add_argument("--batches", type=str, default="32,128,256,512,1024")
parser.add_argument("--image_size", type=int, default=224)
parser.add_argument("--iters", type=int, default=30,
                    help="forwards in each timed chain")
parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with open(CONFIG) as f:
        net = EvalNetwork.from_config(1000, json.load(f))
    params, state = net.init(torch.Generator(device=device).manual_seed(0))
    folded, fparams = fold_batchnorm(net, params, state)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    fparams = tree_map(lambda t: t.to(dtype), fparams)
    rng = np.random.default_rng(0)
    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        x = torch.from_numpy(rng.standard_normal(
            (batch, args.image_size, args.image_size, 3),
            np.float32)).to(device, dtype)
        ms = measure_latency_in_ms(
            lambda p, xx: folded.apply(p, {}, xx, training=False)[0],
            (fparams, x), warmup=args.iters, iters=args.iters)
        ims = batch / ms * 1e3
        rows.append({"batch": batch, "ms_per_batch": ms,
                     "images_per_sec": ims,
                     "vs_reference": ims / REFERENCE_IMS})
        print(f"bs={batch}: {ms:.3f} ms/batch, {ims:,.0f} images/sec "
              f"(vs TF-NAS-A Titan RTX 1775 im/s: "
              f"{ims / REFERENCE_IMS:.1f}x)", flush=True)
        del x
    out = {"metric": "tfnas_a_eval_images_per_sec", "tool":
           "tools_eval_throughput", "config": os.path.relpath(CONFIG, ROOT),
           "dtype": str(dtype).split(".")[-1],
           "image_size": args.image_size, "rows": rows, **describe(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
