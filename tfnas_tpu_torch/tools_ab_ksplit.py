"""A/B of the soft-path lowerings on the real arch step (counterpart of
the repository's tools_ab_ksplit.py).

    python -m tfnas_tpu_torch.tools_ab_ksplit [--eager] [--n 10]

Times make_search_steps(...).arch_step, the search's own arch step (w =
gumbel_softmax(log_alphas) inside the loss), for the four lowerings of
the soft block, each named by both flags: einsum (the default), grouped
(project_einsum=False), ksplit+einsum and ksplit+grouped
(dw_kernel_split=True). One process, one state, one batch and one Gumbel
draw for all (bench.py's state: batch 32, 224^2, 100 classes, bf16 on the
card); two interleaved passes over the variants, of which the second is
reported. On the card each variant's arch step replays from its CUDA
graph (all in one GraphFamily, one memory pool), timed with CUDA events
around n steps; --eager runs the steps eagerly; --device cpu on the host
clock (the tests' plumbing). After 1 + n steps from the same state, each
variant's log_alphas are held against einsum's: the lowerings compute the
same function, so they differ by rounding only.

The last line is one JSON object: per variant the ms per arch step of
both passes, its last loss_a and max |log_alphas - einsum's|.
"""

from __future__ import annotations

import argparse
import json

from .bench import search_setup
from .device import describe, resolve_device
from .models import search_space as ss
from .models.supernet import SuperNetwork
from .search.bisample import gumbel_uniform
from .search.compiled import GraphFamily
from .search.train_step import adam_init, make_search_steps, tree_map
from .tools_profile import elapsed_ms

VARIANTS = {
    "einsum": {},
    "grouped": dict(project_einsum=False),
    "ksplit+einsum": dict(dw_kernel_split=True),
    "ksplit+grouped": dict(dw_kernel_split=True, project_einsum=False),
}

parser = argparse.ArgumentParser("A/B of the soft-path lowerings")
parser.add_argument('--n', type=int, default=10,
                    help='timed arch steps per variant and pass')
parser.add_argument('--eager', action='store_true')
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--space', choices=['mbconv', 'tiny'], default='mbconv')
parser.add_argument('--batch_size', type=int, default=32)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--num_classes', type=int, default=100)


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    space = (ss.tiny_space(args.image_size) if args.space == 'tiny'
             else None)
    _, st, target, gen = search_setup(device, space, args.batch_size,
                                      args.image_size, args.num_classes)
    captured = device.type == "cuda" and not args.eager
    fam = GraphFamily(device) if captured else None
    st["u"] = gumbel_uniform(st["arch"]["log_alphas"].shape, gen)
    if fam is not None:
        st = fam.adopt(st)  # the graphs read the shared state in place
    steps = {name: make_search_steps(
        SuperNetwork(args.num_classes, space=space, **kw),
        num_classes=args.num_classes, target_lat=target, capture=captured,
        family=fam) for name, kw in VARIANTS.items()}

    res = {name: {"ms": []} for name in VARIANTS}
    for pass_idx in range(2):
        for name, s in steps.items():
            carry = [tree_map(lambda t: t.clone(), st["arch"]),
                     adam_init(st["arch"]), None]

            def step():
                carry[:] = s.arch_step(
                    st["params"], carry[0], carry[1], st["masks"], st["x"],
                    st["y"], st["lat"], st["base"], st["T"], st["u"])
            step()
            ms = elapsed_ms(lambda: [step() for _ in range(args.n)],
                            device) / args.n
            res[name]["ms"].append(ms)
            res[name]["loss_a"] = float(carry[2]["loss_a"])
            res[name]["log_alphas"] = carry[0]["log_alphas"].clone()
            print(f"pass{pass_idx} {name:16s} arch_step {ms:8.2f} ms  "
                  f"loss_a {res[name]['loss_a']:.4f}", flush=True)

    ref = res["einsum"]["log_alphas"]
    for name, r in res.items():
        la = r.pop("log_alphas")
        r["max_abs_log_alphas_vs_einsum"] = float(
            (la.double() - ref.double()).abs().max())
        print(f"{name:16s} max |log_alphas - einsum| = "
              f"{r['max_abs_log_alphas_vs_einsum']:.2e}", flush=True)
    out = {"tool": "tools_ab_ksplit", **describe(device),
           "mode": "captured" if captured else "eager",
           "space": args.space, "batch": args.batch_size,
           "image_size": args.image_size, "arch_steps": 1 + args.n,
           "reported_pass": 2,
           "variants": {n: dict(r, ms=r["ms"][1], ms_pass1=r["ms"][0])
                        for n, r in res.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
