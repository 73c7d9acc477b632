#!/usr/bin/env python3
"""Time the fused epilogue kernel (kernels/bias_act.py) against its plain
version and against the op chain the layers run without it, on one CUDA
card, at epilogue sites of the BN-folded TF-NAS-A-class net served at
batch 32 in bf16 (configs/tfnas_a_tpu.config at 224^2); or time that
net's eager folded forward.

    python3 tools_torch_bias_act_times.py
    python3 tools_torch_bias_act_times.py --forward [--root DIR]

The first prints the card's name and power limit, then one JSON line per
site of chip_smoke.EPILOGUE_SITES: the kernel's, the plain version's and
the op chain's `device_ms` (CUDA events around the replay of a CUDA graph
of 20 back-to-back calls on the same operands: a map under the 50 MB L2
stays in it), `cold_ms` (events around single calls after 128 MB are
written) and `host_us` (host clock per call, enqueue only), the kernel's
bound from HBM bytes and its largest error against the plain version in
bf16 units in the last place.

--forward prints one JSON line for each parameter dtype (f32 as folded,
bf16 as cost/measure.py casts them) of one eager folded forward at batch
32, bf16 activations, each list over 5 rounds: `ms`
(CUDA events around 20 back-to-back forwards: device or host time,
whichever is longer) and `host_ms` (host clock per forward, enqueue
only). --root imports the tfnas_tpu_torch package under DIR instead of
this one (a checkout of another commit, to compare the two in turns on
one card).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))


def chain(x, b, act, s, r):
    """The layers' ops without bias_act (ops/conv.py, ops/layers.py): the
    bias cast and its broadcast add, the activation (the SE expand's
    sigmoid in f32), the gate's multiply, the residual add."""
    from tfnas_tpu_torch.ops.activations import apply_act
    four = x.dim() == 4
    if s is not None:
        x = x * s.to(x.dtype)[:, :, None, None]
    if b is not None:
        x = x + (b.to(x.dtype)[None, :, None, None] if four
                 else b.to(x.dtype))
    if act == "sigmoid" and not four:
        x = torch.sigmoid(x.float()).to(torch.bfloat16)
    else:
        x = apply_act(x, act)
    return x if r is None else x + r


def sites():
    from tfnas_tpu_torch.kernels import bias_act
    bias_act.build_library()
    print(json.dumps({"build_s": bias_act.build_info["seconds"],
                      "ptxas": bias_act.build_info["log"][-4000:]}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device="cuda")
    for name, shape, act, *kinds in cs.EPILOGUE_SITES:
        x, b, s, r = cs.epilogue_operands(torch, gen, shape, *kinds)
        row = {"site": name, "shape": list(shape), "act": act,
               "bound_ms": cs.epilogue_bound_ms(x, b, s, r),
               "max_ulps": cs.bf16_ulps(
                   torch, bias_act.bias_act_cuda(x, b, act, s, r),
                   bias_act.bias_act_plain(x, b, act, s, r))}
        for label, fn in (("kernel", bias_act.bias_act_cuda),
                          ("plain", bias_act.bias_act_plain),
                          ("chain", chain)):
            with torch.no_grad():
                dev, cold, host_us = cs._timings(
                    torch, lambda: fn(x, b, act, s, r), flush)
            row[f"{label}_device_ms"] = dev
            row[f"{label}_cold_ms"] = cold
            row[f"{label}_host_us"] = host_us
        print(json.dumps(row), flush=True)


def forward(root, batch=32, reps=20, rounds=5):
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.models.folding import fold_batchnorm
    from tfnas_tpu_torch.search.train_step import tree_map
    with open(os.path.join(ROOT, "configs", "tfnas_a_tpu.config")) as f:
        net = EvalNetwork.from_config(1000, json.load(f))
    dev = torch.device("cuda")
    params, state = net.init(torch.Generator(device=dev).manual_seed(0))
    folded, fparams = fold_batchnorm(net, params, state)
    x = torch.randn((batch, 224, 224, 3), device=dev).bfloat16()
    for tag, p in (("f32", fparams),
                   ("bf16", tree_map(lambda t: t.bfloat16(), fparams))):
        ms, host_ms = [], []
        with torch.no_grad():
            def fwd():
                return folded.apply(p, {}, x)[0]
            for _ in range(rounds):
                ms.append(cs._timed(torch, fwd, reps))
                t = time.perf_counter()
                for _ in range(reps):
                    fwd()
                host_ms.append(1e3 * (time.perf_counter() - t) / reps)
                torch.cuda.synchronize()
        print(json.dumps({"root": root, "params": tag, "batch": batch,
                          "ms": ms, "host_ms": host_ms}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, os.path.abspath(args.root))
    if args.forward:
        forward(args.root)
    else:
        sites()
    return 0


if __name__ == "__main__":
    sys.exit(main())
