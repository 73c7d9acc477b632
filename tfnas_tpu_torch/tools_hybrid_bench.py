"""Step cost of the hybrid conv/ViT space against the MBConv space
(counterpart of the repository's tools_hybrid_bench.py): the bi-sampling
weight step and the soft arch step of the 8-op MBConv supernet and of the
9-op hybrid supernet at the search's shapes (batch 32, 224^2, 100 classes,
bf16 on the card).

    python -m tfnas_tpu_torch.tools_hybrid_bench [--iters 20] [--batch 32]
        [--size 224]

The hybrid sampled path computes both the conv and the ViT branch at the
ViT sites and selects, so its weight steps pay the ViT forward and
backward even when no ViT op is drawn; this measures that. On the card the
steps replay from CUDA graphs (one GraphFamily for both spaces); on the
CPU they run eagerly. Both spaces are warmed (a first step of each kind,
then --warm more) before any timing, then timed interleaved: each
iteration one weight and one arch step of each space, each step between
CUDA events after a synchronize (the host clock on the CPU); the state
carries from step to step. The state is bench.search_setup's with the JAX
tool's latency inputs: a latency vector of ones, target 1, base 0.02.

The last line is one JSON object: median ms per step kind and space
("mbconv", "hybrid": {"w_ms", "a_ms"}), "hybrid_overhead" (their ratios),
the fused kernel's launches by stride and the card; a markdown table
follows it on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .device import describe, resolve_device
from .kernels import fused_dw
from .search.compiled import GraphFamily, adopt
from .search.train_step import make_search_steps
from .tools_profile import elapsed_ms
from .tools_setup import arch_iter, search_setup, weight_iter


def build(space, batch, size, ncls, device, family):
    """One space's (weight step, arch step): each runs a step on the
    space's state, which carries from step to step, and returns its
    loss."""
    hybrid = space == "hybrid"
    net, st, _, gen = search_setup(device, None, batch, size, ncls,
                                   hybrid=hybrid)
    st["lat"] = torch.ones_like(st["lat"])
    st["base"] = torch.tensor(0.02, device=device)
    valid = net.valid_mask(device) if hybrid else None
    st = adopt(family, st)
    steps = make_search_steps(net, num_classes=ncls, target_lat=1.0,
                              valid_mask=valid, family=family)
    return (lambda: weight_iter(steps, st, gen, valid)["loss"],
            lambda: arch_iter(steps, st, gen)["loss_a"])


parser = argparse.ArgumentParser("hybrid against mbconv search steps")
parser.add_argument("--iters", type=int, default=20)
parser.add_argument("--batch", type=int, default=32)
parser.add_argument("--size", type=int, default=224)
parser.add_argument("--num_classes", type=int, default=100)
parser.add_argument("--warm", type=int, default=3,
                    help="steps of each kind after the first, untimed")
parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    fused_dw.reset_launches()
    family = GraphFamily(device) if device.type == "cuda" else None
    states = {sp: build(sp, args.batch, args.size, args.num_classes, device,
                        family) for sp in ("mbconv", "hybrid")}

    for sp, (wstep, astep) in states.items():  # capture and warm both
        for _ in range(1 + args.warm):
            float(wstep())
            float(astep())
        print(f"{sp}: warmed", flush=True)

    res = {sp: {"w_ms": [], "a_ms": []} for sp in states}
    for _ in range(args.iters):  # interleaved warm passes
        for sp, (wstep, astep) in states.items():
            res[sp]["w_ms"].append(elapsed_ms(wstep, device))
            res[sp]["a_ms"].append(elapsed_ms(astep, device))

    out = {sp: {k: float(np.median(v)) for k, v in res[sp].items()}
           for sp in states}
    out["hybrid_overhead"] = {k: out["hybrid"][k] / out["mbconv"][k]
                              for k in ("w_ms", "a_ms")}
    out.update(tool="tools_hybrid_bench",
               mode="captured" if family else "eager", batch=args.batch,
               size=args.size, iters=args.iters,
               fused_dw=fused_dw.launch_counts(), **describe(device))
    print(json.dumps(out), flush=True)
    print("\n| Space | weight step (ms) | arch step (ms) |\n|---|---|---|",
          file=sys.stderr)
    for sp in ("mbconv", "hybrid"):
        print(f"| {sp} | {out[sp]['w_ms']:.2f} | {out[sp]['a_ms']:.2f} |",
              file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
