"""Per-segment time and FLOPs of a BN-folded eval net on one card
(counterpart of the repository's tools_profile_eval.py).

    python -m tfnas_tpu_torch.tools_profile_eval --config_path PATH
        [--batch_size 256] [--image_size 224] [--peak_tflops 989]

Times cumulative prefixes of the folded bf16 network (the first stem, +
the second stem, + stage1, ..., + stage6, + the head), each as a chain of
dependent forwards replayed from one CUDA graph (cost/measure.py),
subtracts the empty chain's time and takes the differences; beside each
segment its analytic multiply-accumulates (cost/flops.py layer_flops,
counted once, as the reference's hooks count them) and their rate (x 2
FLOPs) against the card's peak. The stems are two segments, so that the
3-channel first convolution stands apart from the 112^2 depthwise block.

--peak_tflops defaults to 989, the dense bf16 tensor-core rate of the
H100 SXM in NVIDIA's data sheet, which assumes its 700 W limit; the
output names the card and its power limit beside the shares. Depthwise
convolutions do not run on the tensor cores, so an MBConv network's share
of that peak is bounded by its 1x1 convolutions' share of the work.
--device cpu runs the chains eagerly on the host clock (the tests'
plumbing: CPU numbers, not the card's).
"""

from __future__ import annotations

import argparse
import glob
import json

import numpy as np
import torch

from .cost.flops import layer_flops
from .cost.measure import measure_latency_in_ms
from .device import describe, resolve_device
from .models.eval_net import EvalNetwork
from .models.folding import fold_batchnorm
from .search.train_step import tree_map

H100_BF16_DENSE_TFLOPS = 989.0


def prefix_apply(net, upto):
    """fn(params, x) of the eval-mode forward through the first `upto`
    segments of `net` (x: [N, H, W, 3]): 1 the first stem, 2 + the second
    stem, 3..8 + stage1..stage6, 9 + the head. upto = 0 is the empty
    chain's body: it reads one pixel row."""
    stage_names = list(net.stages)

    def fn(params, x):
        if upto == 0:
            return x[:, 0, 0, :].sum()
        h, _ = net.first_stem.apply(params["first_stem"], {},
                                    x.permute(0, 3, 1, 2), training=False)
        if upto >= 2:
            h, _ = net.second_stem.apply(params["second_stem"], {}, h,
                                         training=False)
        for s, stage in enumerate(stage_names[:max(upto - 2, 0)]):
            for i, block in enumerate(net.stages[stage]):
                h, _ = block.apply(params[stage][f"block{i + 1}"], {}, h,
                                   training=False)
        if upto >= len(stage_names) + 3:
            h, _ = net.feature_mix_layer.apply(params["feature_mix_layer"],
                                               {}, h, training=False)
            h, _ = net.classifier.apply(params["classifier"], {},
                                        h.mean(dim=(2, 3)), training=False)
        return h

    return fn


def segment_flops(net, image_size):
    """[(name, MMACs per image)] of each segment at this resolution."""
    segs, res = [], image_size
    f, res = layer_flops(net.first_stem, res)
    segs.append(("first_stem", f))
    f, res = layer_flops(net.second_stem, res)
    segs.append(("second_stem", f))
    for stage, blocks in net.stages.items():
        tot = 0.0
        for b in blocks:
            fb, res = layer_flops(b, res)
            tot += fb
        segs.append((stage, tot))
    f, res = layer_flops(net.feature_mix_layer, res)
    f += net.feature_mix_layer.out_channels * res * res  # the pool
    fc, _ = layer_flops(net.classifier, 1)
    segs.append(("head", f + fc))
    return [(n, fl / 1e6) for n, fl in segs]


parser = argparse.ArgumentParser("per-segment time of a folded eval net")
parser.add_argument('--config_path', required=True)
parser.add_argument('--num_classes', type=int, default=30)
parser.add_argument('--batch_size', type=int, default=256)
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--peak_tflops', type=float,
                    default=H100_BF16_DENSE_TFLOPS,
                    help='the card\'s dense bf16 peak (H100 SXM: 989)')
parser.add_argument('--iters', type=int, default=50)
parser.add_argument('--json_out', default='')
parser.add_argument('--device', type=str, default='cuda')


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg_path = sorted(glob.glob(args.config_path))[-1]
    with open(cfg_path) as f:
        net = EvalNetwork.from_config(args.num_classes, json.load(f))
    params, state = net.init(torch.Generator(device=device).manual_seed(0))
    folded, fparams = fold_batchnorm(net, params, state)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    fparams = tree_map(lambda t: t.to(dtype), fparams)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch_size, args.image_size, args.image_size, 3),
        np.float32)).to(device, dtype)

    segs = segment_flops(folded, args.image_size)
    floor_ms = measure_latency_in_ms(prefix_apply(folded, 0), (fparams, x0),
                                     args.iters, args.iters)
    print(f"chain floor (empty chain): {floor_ms:.3f} ms/iter", flush=True)
    cum_ms = []
    for upto in range(1, len(segs) + 1):
        cum_ms.append(measure_latency_in_ms(
            prefix_apply(folded, upto), (fparams, x0), args.iters,
            args.iters) - floor_ms)
        print(f"prefix {upto}/{len(segs)} ({segs[upto - 1][0]}): "
              f"{cum_ms[-1]:.3f} ms cumulative", flush=True)

    card = describe(device)
    print(f"\nconfig: {cfg_path}\n{card}")
    print(f"batch {args.batch_size} @ {args.image_size}px, BN-folded, "
          f"{str(dtype)[6:]}; peak {args.peak_tflops} TFLOP/s")
    print("| segment | ms | MMACs | GFLOP/s | % of peak |")
    print("|---|---|---|---|---|")
    rows, prev = [], 0.0
    for (name, mf), cms in zip(segs, cum_ms):
        dms = max(cms - prev, 0.0)
        prev = cms
        gfs = 2.0 * mf * args.batch_size / dms if dms > 0 else None
        pct = gfs / (args.peak_tflops * 1e3) * 100.0 if gfs else None
        rows.append({"segment": name, "ms": dms, "MMACs": mf,
                     "GFLOPs_s": gfs, "pct_peak": pct})
        print(f"| {name} | {dms:.3f} | {mf:.1f} | {gfs or 0:.0f} | "
              f"{pct or 0:.1f} |")
    total_f = sum(f for _, f in segs)
    tot_gfs = 2.0 * total_f * args.batch_size / cum_ms[-1]
    out = {"tool": "tools_profile_eval", **card, "config": cfg_path,
           "batch_size": args.batch_size, "image_size": args.image_size,
           "peak_tflops": args.peak_tflops, "floor_ms": floor_ms,
           "total_ms": cum_ms[-1], "total_MMACs": total_f,
           "total_pct_peak": tot_gfs / (args.peak_tflops * 1e3) * 100.0,
           "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
