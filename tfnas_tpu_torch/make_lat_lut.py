"""Build a latency lookup table for the card (counterpart of the repository's
make_lat_lut_tpu.py).

    python -m tfnas_tpu_torch.make_lat_lut --mode measure \
        --output latency_pkl/latency_h100.pkl [--resume]

The table has the reference schema: 'base' -> ms of the stem, second stem,
head, global pooling and classifier, and one key per block site
'MBInvertedResBlock_{res}_{cin}_{se}_{cout}_k{K}_s{S}_{act}' -> {mid
channels: ms} for every integer mid width.

- measure: every key's block (the eval-style MBInvertedResBlock, bf16, BN
  in inference mode) is timed on the card with cost/measure.py at a grid of
  mid widths, interpolated to every integer and fitted monotone (pool
  adjacent violators). The table is written atomically after 'base' and
  after every key, so --resume continues an interrupted build.
- analytic: make_lat_lut_tpu.py's roofline formulas (max of the matmul
  time at the peak rate and the bytes at the memory rate, plus a launch
  overhead) with the H100 SXM data sheet's rates below.

--space hybrid appends the 5 keys of the hybrid space's ViT candidate,
'ViTBlock_{res}_{cin}_h4_{cout}_s{S}_{act}' -> {MLP hidden width: ms}
(models/hybrid_space.py): measured as an affine ViTBlock in bf16 at the
batch, or from the roofline. With --resume on a copy of an mbconv table,
only those keys are measured and the others stay as they were.
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle
import time
from collections import OrderedDict

import numpy as np
import torch

from .cost.lut import (ANALYTIC_OVERHEAD_S, analytic_block_ms,
                       analytic_vit_ms, save_lat_lookup)
from .cost.measure import measure_latency_in_ms
from .device import resolve_device
from .models import hybrid_space as hs
from .models import search_space as ss
from .ops.layers import ConvLayer, LinearLayer, MBInvertedResBlock
from .search.train_step import tree_map

# H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
H100_PEAK_FLOPS = 989e12
H100_PEAK_BW = 3.35e12
LAUNCH_OVERHEAD_S = ANALYTIC_OVERHEAD_S


def site_list():
    """The 11 distinct (res, cin, cout, stride, act) block sites of the
    skeleton (66 keys, 6 per site)."""
    sites = []
    for stage, spec in ss.STAGE_SPECS.items():
        for b in range(len(spec["ics"])):
            t = (ss.BLOCK_INPUT_RES[stage][b], spec["ics"][b],
                 spec["ocs"][b], spec["ss"][b], spec["acts"][b])
            if t not in sites:
                sites.append(t)
    return sites


def site_keys():
    """(key, res, cin, se, cout, k, stride, act, max_mc) of the conv
    candidates, in make_lat_lut_tpu.py's order."""
    out = []
    for res, cin, cout, stride, act in site_list():
        for k in (3, 5):
            for se_mult, e_max in ((0, 8), (1, 4), (2, 8)):
                se = se_mult * cin
                out.append((f"MBInvertedResBlock_{res}_{cin}_{se}_{cout}"
                            f"_k{k}_s{stride}_{act}", res, cin, se, cout, k,
                            stride, act, cin * e_max))
    return out


def vit_keys():
    """(key, res, cin, cout, stride, act, max_mc) of the hybrid space's ViT
    candidate, after the conv keys as make_lat_lut_tpu.py appends them."""
    return [(hs.vit_lut_key(res, cin, cout, stride, act), res, cin, cout,
             stride, act, cout * hs.VIT_MAX_EXPAND)
            for res, cin, cout, stride, act in hs.vit_lut_sites()]


# -- analytic mode ------------------------------------------------------------

def analytic_base_ms(batch=32, peak_flops=H100_PEAK_FLOPS,
                     peak_bw=H100_PEAK_BW, overhead=LAUNCH_OVERHEAD_S):
    """Stem + head latency ('base') from the roofline."""
    total = 0.0
    total += max(2 * 112 * 112 * 9 * 3 * 32 * batch / peak_flops,
                 batch * (224 * 224 * 3 + 112 * 112 * 32) * 2 / peak_bw)
    total += analytic_block_ms(112, 32, 8, 16, 3, 1, 32, batch,
                               peak_flops=peak_flops, peak_bw=peak_bw,
                               overhead=overhead) / 1000.0
    total += max(2 * 7 * 7 * 320 * 1280 * batch / peak_flops,
                 batch * (7 * 7 * (320 + 1280)) * 2 / peak_bw)
    total += batch * 7 * 7 * 1280 * 2 / peak_bw
    total += max(2 * 1280 * 1000 * batch / peak_flops,
                 (1280 * 1000) * 2 / peak_bw)
    total += 5 * overhead
    return total * 1000.0


def build_analytic_lut(batch=32, scale=1.0, peak_flops=H100_PEAK_FLOPS,
                       peak_bw=H100_PEAK_BW, overhead=LAUNCH_OVERHEAD_S,
                       space="mbconv"):
    """The full space's roofline table (with the ViT keys for
    space='hybrid')."""
    peaks = dict(peak_flops=peak_flops, peak_bw=peak_bw, overhead=overhead)
    lut = OrderedDict()
    lut["base"] = analytic_base_ms(batch, **peaks) * scale
    for key, res, cin, se, cout, k, stride, _, max_mc in site_keys():
        lut[key] = OrderedDict(
            (mc, analytic_block_ms(res, cin, se, cout, k, stride, mc, batch,
                                   **peaks) * scale)
            for mc in range(1, max_mc + 1))
    if space == "hybrid":
        for key, res, cin, cout, stride, _, max_mc in vit_keys():
            lut[key] = OrderedDict(
                (mc, analytic_vit_ms(res, cin, cout, stride, mc, batch,
                                     **peaks) * scale)
                for mc in range(1, max_mc + 1))
    return lut


# -- measured mode ------------------------------------------------------------

def isotonic_fit(vals):
    """Least-squares monotone non-decreasing fit (pool adjacent
    violators), clamped at 0: the elasticity loop assumes more channels
    never cost less, and noise at the microsecond scale can make a measured
    curve dip."""
    blocks = []  # (mean, count)
    for x in (float(v) for v in vals):
        cur_v, cur_n = x, 1
        while blocks and blocks[-1][0] > cur_v:
            pv, pn = blocks.pop()
            cur_v = (pv * pn + cur_v * cur_n) / (pn + cur_n)
            cur_n += pn
        blocks.append((cur_v, cur_n))
    out = []
    for val, n in blocks:
        out.extend([max(val, 0.0)] * n)
    return out


def apply_isotonic(lut):
    """Monotonise every block key's mc -> ms curve in place."""
    for key, d in lut.items():
        if key == "base":
            continue
        for mc, val in zip(list(d), isotonic_fit(d.values())):
            d[mc] = val
    return lut


def mc_points(max_mc, stride_points):
    """The measured mid widths of a key: 1, max_mc and every
    max_mc // stride_points."""
    return sorted(set([1, max_mc] + list(
        range(0, max_mc + 1, max(max_mc // stride_points, 1)))[1:]))


def time_layer(layer, shape, device, warmup, iters):
    """ms of layer.apply in inference mode, bf16, on a random input of
    `shape` ([N, H, W, C] as channels_last NCHW, or [N, F]); parameters
    cast to bf16 once."""
    params, state = layer.init(torch.Generator(device=device).manual_seed(0))
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape, np.float32)).to(device, torch.bfloat16)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)

    def fwd(p, s, xx):
        return layer.apply(p, s, xx, training=False)[0]
    return measure_latency_in_ms(fwd, (params, state, x), warmup, iters)


def measure_block_ms(res, cin, se, cout, k, stride, act, mc, batch, device,
                     warmup, iters):
    block = MBInvertedResBlock(cin, mc, se, cout, kernel_size=k,
                               stride=stride, affine=True, act_func=act)
    return time_layer(block, (batch, res, res, cin), device, warmup, iters)


def measure_vit_ms(res, cin, cout, stride, act, mc, batch, device, warmup,
                   iters):
    """The ViT candidate as the eval network holds it (affine LN)."""
    block = hs.make_vit_op((cin, cout, stride, act), mc, affine=True)
    return time_layer(block, (batch, res, res, cin), device, warmup, iters)


def measure_base_ms(batch, device, warmup, iters):
    """The five fixed modules at their true shapes."""
    base = time_layer(ConvLayer(affine=True, **ss.STEM_CONV),
                      (batch, 224, 224, 3), device, warmup, iters)
    base += time_layer(MBInvertedResBlock(affine=True, **ss.SECOND_STEM),
                       (batch, 112, 112, 32), device, warmup, iters)
    base += time_layer(ConvLayer(affine=True, **ss.HEAD_CONV),
                       (batch, 7, 7, 320), device, warmup, iters)
    x = torch.zeros((batch, ss.HEAD_FEATURES, 7, 7), dtype=torch.bfloat16,
                    device=device)
    base += measure_latency_in_ms(lambda xx: xx.mean(dim=(2, 3)), (x,),
                                  warmup, iters)
    base += time_layer(LinearLayer(ss.HEAD_FEATURES, 1000),
                       (batch, ss.HEAD_FEATURES), device, warmup, iters)
    return base


def build_measured_lut(batch=32, stride_points=16, warmup=10, iters=50,
                       device="cuda", log=print, max_keys=0, resume_lut=None,
                       checkpoint=None, space="mbconv"):
    """Measure each key at mc_points, interpolate to every integer.
    resume_lut: a partial table whose keys are kept; checkpoint(lut) is
    called after 'base' and after every key. space='hybrid' appends the
    ViT keys; max_keys counts the conv keys first."""
    lut = OrderedDict(resume_lut or {})
    checkpoint = checkpoint or (lambda lut: None)
    if "base" in lut:
        log(f"base = {lut['base']:.4f} ms (resumed)")
    else:
        lut["base"] = measure_base_ms(batch, device, warmup, iters)
        log(f"base = {lut['base']:.4f} ms")
        checkpoint(lut)
    jobs = [(key, max_mc, functools.partial(
                measure_block_ms, res, cin, se, cout, k, stride, act))
            for key, res, cin, se, cout, k, stride, act, max_mc
            in site_keys()]
    if space == "hybrid":
        jobs += [(key, max_mc, functools.partial(
                     measure_vit_ms, res, cin, cout, stride, act))
                 for key, res, cin, cout, stride, act, max_mc in vit_keys()]
    for done, (key, max_mc, measure) in enumerate(jobs):
        if max_keys and done >= max_keys:
            break
        if key in lut:
            log(f"{key}: resumed")
            continue
        t = time.perf_counter()
        pts = mc_points(max_mc, stride_points)
        lats = [measure(mc, batch, device, warmup, iters) for mc in pts]
        xs = np.arange(1, max_mc + 1)
        lut[key] = OrderedDict((int(mc), float(v)) for mc, v in
                               zip(xs, np.interp(xs, pts, lats)))
        log(f"{key}: [{lats[0]:.4f} .. {lats[-1]:.4f}] ms ({len(pts)} "
            f"points, {time.perf_counter() - t:.1f} s)")
        checkpoint(lut)
    return lut


parser = argparse.ArgumentParser("build a latency LUT on the card")
parser.add_argument('--mode', choices=['analytic', 'measure'],
                    default='analytic')
parser.add_argument('--output', type=str,
                    default='./latency_pkl/latency_h100.pkl')
parser.add_argument('--batch_size', type=int, default=32)
parser.add_argument('--stride_points', type=int, default=16,
                    help='measured mc points per key (measure mode)')
parser.add_argument('--warmup', type=int, default=10)
parser.add_argument('--iters', type=int, default=50)
parser.add_argument('--scale', type=float, default=1.0,
                    help='calibration scale for analytic mode')
parser.add_argument('--max_keys', type=int, default=0,
                    help='measure only the first N keys (smoke runs)')
parser.add_argument('--resume', action='store_true',
                    help='measure mode: keep keys already in --output and '
                         'continue from the first missing one')
parser.add_argument('--no_isotonic', dest='isotonic', action='store_false',
                    default=True,
                    help='measure mode: skip the monotone fit of each '
                         'mc -> latency curve')
parser.add_argument('--space', choices=['mbconv', 'hybrid'],
                    default='mbconv')
parser.add_argument('--device', type=str, default='cuda')


def main(argv=None):
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(args.output) or '.', exist_ok=True)

    def write_atomic(lut):
        tmp = args.output + '.tmp'
        save_lat_lookup(lut, tmp)
        os.replace(tmp, args.output)

    if args.mode == 'analytic':
        lut = build_analytic_lut(args.batch_size, args.scale,
                                 space=args.space)
    else:
        device = resolve_device(args.device)
        resume_lut = None
        if args.resume and os.path.exists(args.output):
            with open(args.output, 'rb') as f:
                resume_lut = pickle.load(f)
            print(f"resuming: {len(resume_lut)} keys already in "
                  f"{args.output}")
        lut = build_measured_lut(args.batch_size, args.stride_points,
                                 args.warmup, args.iters, device,
                                 max_keys=args.max_keys,
                                 resume_lut=resume_lut,
                                 checkpoint=write_atomic, space=args.space)
        if args.isotonic:
            lut = apply_isotonic(lut)
    write_atomic(lut)
    print(f"wrote {len(lut)} keys -> {args.output}")
    return lut


if __name__ == '__main__':
    main()
