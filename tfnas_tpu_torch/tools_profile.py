"""Time each piece of the bi-level search step on one card (counterpart of
the repository's tools_profile.py).

    python -m tfnas_tpu_torch.tools_profile [--eager] [--grouped_project]
        [--dw_kernel_split] [--only ROW]

The supernet and its state are bench.py's (batch 32, 224^2, 100 classes,
bf16 on the card, latency_pkl/latency_tpu.pkl). Rows, in the JAX tool's
order: the sampled forward and forward + backward (op 0 at every block),
the bi-sampling pair's forward + backward (ops 0 and 1, one stem), the
soft forward (8 branches, uniform weights), the soft arch gradient, one
weight_step and one arch_step, and the combined iteration (a weight step
and half an arch step, with its steps/s).

On the card each row is one CUDA graph (search/compiled.py) replayed back
to back between CUDA events: the card's time. --eager calls the functions
instead (events around the calls: the host's or the card's time,
whichever is longer). --device cpu runs eagerly on the host clock, for the
tests: its numbers are the CPU's.

The soft arch-grad row keeps the JAX tool's constant weights, so that
d loss / d log_alphas is zero. XLA dropped the work behind that zero
unevenly across the lowerings. PyTorch drops nothing; it computes what
the requested gradient needs and no more: the input gradients of every
block (the betas need them), no weight gradient and no d loss / d w. The
row thus does the same work in every lowering; the lowerings' verdicts
come from tools_ab_ksplit, which times the real arch step.

The last line is one JSON object: the card, the flags and the rows' ms.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench import search_setup
from .device import describe, resolve_device
from .models import search_space as ss
from .search.bisample import (gumbel_uniform, sample_gumbel_indices,
                              sample_random_excluding)
from .search.compiled import GraphedFn, GraphFamily
from .search.train_step import make_search_steps, value_and_grad
from .utils.metrics import cross_entropy

STEP_ROWS = ("weight_step (bi-sample)", "arch_step (soft)",
             "combined iter (w + a/2)")


def elapsed_ms(fn, device):
    """ms that one call of fn takes: CUDA events around it on the card
    (the card's time, or the host's where enqueueing takes longer), the
    host clock on the CPU."""
    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, device, iters, warmup=2):
    """ms per call over `iters` back-to-back calls after `warmup`."""
    for _ in range(warmup):
        fn()
    return elapsed_ms(lambda: [fn() for _ in range(iters)], device) / iters


def piece_rows(net, st):
    """(name, fn, args) of the rows below the steps; each fn returns a
    tuple (a graph's outputs)."""
    arch, masks = st["arch"], st["masks"]
    nblk = arch["log_alphas"].shape[0]
    dev = arch["log_alphas"].device
    idx0 = torch.zeros(nblk, dtype=torch.long, device=dev)
    idx1 = torch.ones(nblk, dtype=torch.long, device=dev)
    w = torch.full((nblk, ss.NUM_OPS), 1.0 / ss.NUM_OPS, device=dev)
    lat = torch.ones((nblk, ss.NUM_OPS), device=dev)

    def sampled_fwd(p, x):
        with torch.no_grad():
            return (net.apply_sampled(p, arch, masks, x, idx0),)

    def sampled_grad(p, x, y):
        return value_and_grad(lambda q: (cross_entropy(
            net.apply_sampled(q, arch, masks, x, idx0), y), None), p)

    def pair_grad(p, x, y):
        def loss(q):
            lg, lr = net.apply_sampled_pair(q, arch, masks, x, idx0, idx1)
            return cross_entropy(lg, y) + cross_entropy(lr, y), None
        return value_and_grad(loss, p)

    def soft_fwd(p, x):
        with torch.no_grad():
            return (net.apply_soft(p, arch, masks, x, w, lat)[0],)

    def soft_arch_grad(a, p, x, y):
        def loss(b):
            logits, l = net.apply_soft(p, b, masks, x, w, lat)
            return cross_entropy(logits, y) + l * 0.0, None
        return value_and_grad(loss, a)

    p, x, y = st["params"], st["x"], st["y"]
    return [("sampled fwd", sampled_fwd, (p, x)),
            ("sampled fwd+bwd", sampled_grad, (p, x, y)),
            ("bi-sample pair fwd+bwd (shared stem)", pair_grad, (p, x, y)),
            ("soft fwd (8 branches)", soft_fwd, (p, x)),
            ("soft arch grad", soft_arch_grad, (arch, p, x, y))]


parser = argparse.ArgumentParser("time the pieces of the search step")
parser.add_argument('--grouped_project', action='store_true',
                    help='the soft-path project as grouped convolutions '
                         '(project_einsum=False)')
parser.add_argument('--dw_kernel_split', action='store_true',
                    help='the true-tap k3/k5 depthwise split in the soft '
                         'path')
parser.add_argument('--only', type=str, default='',
                    help='substring filter of the rows to run')
parser.add_argument('--eager', action='store_true',
                    help='call the functions instead of replaying graphs')
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--space', choices=['mbconv', 'tiny'], default='mbconv')
parser.add_argument('--batch_size', type=int, default=32)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--num_classes', type=int, default=100)
parser.add_argument('--iters', type=int, default=10)


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    space = (ss.tiny_space(args.image_size) if args.space == 'tiny'
             else None)
    net, st, target, gen = search_setup(
        device, space, args.batch_size, args.image_size, args.num_classes,
        project_einsum=not args.grouped_project,
        dw_kernel_split=args.dw_kernel_split)
    captured = device.type == "cuda" and not args.eager
    fam = GraphFamily(device) if captured else None
    if fam is not None:
        st = fam.adopt(st)  # graphs read the state in place

    def want(name):
        return args.only in name

    rows = {}
    for name, fn, fargs in piece_rows(net, st):
        if not want(name):
            continue
        call = GraphedFn(fam, fn, {}, name) if captured else fn
        rows[name] = time_ms(lambda: call(*fargs), device, args.iters)
        print(f"{name:40s} {rows[name]:9.2f} ms", flush=True)

    if any(want(n) for n in STEP_ROWS):
        steps = make_search_steps(net, num_classes=args.num_classes,
                                  target_lat=target, capture=captured,
                                  family=fam)
        la = st["arch"]["log_alphas"]
        ig = sample_gumbel_indices(la, gen)
        ir = sample_random_excluding(ig, ss.NUM_OPS, gen)
        u = gumbel_uniform(la.shape, gen)

        def weight_step():
            st["params"], st["mom"], _ = steps.weight_step(
                st["params"], st["arch"], st["mom"], st["masks"],
                st["umasks"], st["x"], st["y"], st["lr"], ig, ir)

        def arch_step():
            st["arch"], st["opt"], _ = steps.arch_step(
                st["params"], st["arch"], st["opt"], st["masks"], st["x"],
                st["y"], st["lat"], st["base"], st["T"], u)

        w_ms = time_ms(weight_step, device, args.iters)
        a_ms = time_ms(arch_step, device, args.iters)
        rows.update({STEP_ROWS[0]: w_ms, STEP_ROWS[1]: a_ms,
                     STEP_ROWS[2]: w_ms + 0.5 * a_ms})
        for name in STEP_ROWS:
            print(f"{name:40s} {rows[name]:9.2f} ms", flush=True)
        print(f"-> {1e3 / rows[STEP_ROWS[2]]:.2f} steps/s", flush=True)

    out = {"tool": "tools_profile", **describe(device),
           "mode": "captured" if captured else "eager",
           "space": args.space, "batch": args.batch_size,
           "image_size": args.image_size,
           "grouped_project": args.grouped_project,
           "dw_kernel_split": args.dw_kernel_split, "iters": args.iters,
           "ms": rows}
    if STEP_ROWS[2] in rows:
        out["steps_per_s"] = 1e3 / rows[STEP_ROWS[2]]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
