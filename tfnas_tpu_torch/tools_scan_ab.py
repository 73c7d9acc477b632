"""A/B of per-step replays against K scanned units (counterpart of the
repository's tools_scan_ab.py): steady-state weight steps per second of
the bi-level inner loop, a bi-sampling weight step every step and a soft
arch step after every second one's partner, for K in --units.

    python -m tfnas_tpu_torch.tools_scan_ab [--units 1,4,8]
        [--timed_units 16] [--rounds 3]

K = 1 calls the steps one by one (the arch step after the first weight
step of each pair, the driver's order at --scan_units 1); K > 1 runs
make_scanned_search_iter, K units of (2 weight steps + 1 arch step) per
call. On the card every step replays from its CUDA graph (one GraphFamily
for all variants), so K > 1 is a host loop over the same graphs; on the
CPU the steps run eagerly. The JAX tool's state: the full space at batch 32,
224^2, 100 classes, bf16 on the card, a latency vector of ones, base 1 and
target 15. Each variant runs once untimed, then --rounds interleaved warm
passes of --timed_units units each; the input is perturbed by the last
loss between passes. The per-variant best rate is reported.

The last line is one JSON object: the JAX tool's summary keys
("K=1 (per-step)", "K=4 (scan)", ...: best weight steps/s), each pass's
rate, the fused kernel's launches by stride and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .device import describe, resolve_device
from .kernels import fused_dw
from .models import search_space as ss
from .search.compiled import GraphFamily, adopt
from .search.train_step import make_scanned_search_iter, make_search_steps
from .tools_setup import search_iter, search_setup

parser = argparse.ArgumentParser("scan A/B")
parser.add_argument("--batch", type=int, default=32)
parser.add_argument("--size", type=int, default=224)
parser.add_argument("--units", default="1,4,8")
parser.add_argument("--timed_units", type=int, default=16,
                    help="units (2 weight + 1 arch step each) timed per "
                         "pass")
parser.add_argument("--rounds", type=int, default=3)
parser.add_argument("--device", type=str, default="cuda")
parser.add_argument("--space", choices=["mbconv", "tiny"], default="mbconv")
parser.add_argument("--num_classes", type=int, default=100)


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    space = ss.tiny_space(args.size) if args.space == "tiny" else None
    ncls = args.num_classes
    fused_dw.reset_launches()
    net, st, _, gen = search_setup(device, space, args.batch, args.size,
                                   ncls)
    st["lat"] = torch.ones_like(st["lat"])
    st["base"] = torch.tensor(1.0, device=device)
    fam = GraphFamily(device) if device.type == "cuda" else None
    st = adopt(fam, st)
    steps = make_search_steps(net, num_classes=ncls, target_lat=15.0,
                              family=fam)
    scan = make_scanned_search_iter(net, num_classes=ncls, arch_every=2,
                                    steps=steps)

    def run_per_step(n_units, x):
        st["x"] = x
        for i in range(n_units * 2):
            met = search_iter(steps, st, gen, i)
        return met["loss"], n_units * 2

    def run_scanned(K, n_units, x):
        p, m, a, o = st["params"], st["mom"], st["arch"], st["opt"]
        y = st["y"]
        xw, yw = x.expand(K, 2, *x.shape), y.expand(K, 2, *y.shape)
        xa, ya = x.expand(K, *x.shape), y.expand(K, *y.shape)
        for _ in range(n_units // K):
            p, m, a, o, wmet, _ = scan(
                p, m, a, o, st["masks"], st["umasks"], xw, yw, xa, ya,
                st["lr"], st["T"], st["lat"], st["base"], gen)
        st.update(params=p, mom=m, arch=a, opt=o)
        return wmet["loss"], (n_units // K) * K * 2

    variants = {}
    for K in (int(u) for u in args.units.split(",")):
        if K == 1:
            variants["K=1 (per-step)"] = (
                lambda x: run_per_step(args.timed_units, x))
        else:
            variants[f"K={K} (scan)"] = (
                lambda x, K=K: run_scanned(K, args.timed_units, x))

    def timed(fn, x):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        loss, n_weight = fn(x)
        loss = float(loss.reshape(-1)[-1])  # waits for the last step
        return n_weight / (time.perf_counter() - tic), loss

    x = st["x"]
    for name, fn in variants.items():
        tic = time.perf_counter()
        timed(fn, x)
        print(f"{name}: built and first pass in "
              f"{time.perf_counter() - tic:.1f}s", flush=True)

    results = {name: [] for name in variants}
    for r in range(args.rounds):
        for name, fn in variants.items():
            rate, loss = timed(fn, x)
            results[name].append(rate)
            x = x + torch.tensor(loss * 1e-6, device=device).to(x.dtype)
            print(f"round {r} {name}: {rate:.2f} weight-steps/s", flush=True)

    summary = {name: max(rates) for name, rates in results.items()}
    for name, best in summary.items():
        print(f"{name}: best {best:.2f} weight-steps/s")
    out = {**summary, "tool": "tools_scan_ab",
           "mode": "captured" if fam else "eager",
           "space": args.space, "batch": args.batch, "size": args.size,
           "timed_units": args.timed_units, "rounds": results,
           "fused_dw": fused_dw.launch_counts(), **describe(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
