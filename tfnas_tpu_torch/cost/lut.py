"""Latency lookup table (counterpart of tfnas_tpu/cost/lut.py).

The pickle schema is the reference's: 'base' -> ms for stem + head, and one
key per block site 'MBInvertedResBlock_{res}_{cin}_{se}_{cout}_k{K}_s{S}_{act}'
-> {mid_channels: ms} for every integer mid width. The shipped tables under
`latency_pkl/` hold TPU times: the search uses them as the latency target
it optimises toward, not as times of this card.

`build_space_analytic_lut` is a copy of the roofline table that
make_lat_lut_tpu.py builds for reduced spaces (tiny_space fixtures), so the
port's `--space tiny` runs need no JAX. Its constants are that builder's,
kept equal so both packages search against the same synthetic table.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict

import numpy as np

from ..models import search_space as ss

# make_lat_lut_tpu.py's defaults, kept so the synthetic table is identical
ANALYTIC_PEAK_FLOPS = 394e12 / 2
ANALYTIC_PEAK_BW = 819e9
ANALYTIC_OVERHEAD_S = 5e-6


def load_lat_lookup(path, clamp_negative=True):
    """Load a LUT pickle; negative fitted entries are clamped to 0 so the
    differentiable latency stays >= 0."""
    with open(path, "rb") as f:
        lut = pickle.load(f)
    if clamp_negative:
        for key, val in lut.items():
            if key == "base":
                continue
            for mc in val:
                if val[mc] < 0.0:
                    val[mc] = 0.0
    return lut


def save_lat_lookup(lut, path):
    """Pickle a LUT with the default protocol: the same bytes as the JAX
    package's save_lat_lookup for the same table."""
    with open(path, "wb") as f:
        pickle.dump(lut, f)


def lat_vectors_for_mc(lat_lookup, mc_num_dddict, key_dddict=None,
                       num_ops=None):
    """float32 [TOTAL_BLOCKS, NUM_OPS]: entry (b, o) is the latency of op o
    of block b at its current mid width."""
    if key_dddict is None:
        key_dddict = ss.lat_lookup_key_dddict
    if num_ops is None:
        num_ops = ss.NUM_OPS
    total_blocks = sum(len(key_dddict[stage]) for stage in key_dddict)
    out = np.zeros((total_blocks, num_ops), np.float32)
    b = 0
    for stage in key_dddict:
        for block in key_dddict[stage]:
            for op_idx in key_dddict[stage][block]:
                key = key_dddict[stage][block][op_idx]
                mc = mc_num_dddict[stage][block][op_idx]
                out[b, op_idx] = lat_lookup[key][mc]
            b += 1
    return out


def get_lookup_latency(parsed_arch, mc_num_dddict, lat_lookup_key_dddict,
                       lat_lookup):
    """LUT latency of a parsed architecture."""
    lat = lat_lookup["base"]
    for stage in parsed_arch:
        for block in parsed_arch[stage]:
            op_idx = parsed_arch[stage][block]
            mc = mc_num_dddict[stage][block][op_idx]
            key = lat_lookup_key_dddict[stage][block][op_idx]
            lat += lat_lookup[key][mc]
    return lat


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def analytic_block_ms(res, cin, se, cout, k, stride, mc, batch=32,
                      dtype_bytes=2, peak_flops=ANALYTIC_PEAK_FLOPS,
                      peak_bw=ANALYTIC_PEAK_BW,
                      overhead=ANALYTIC_OVERHEAD_S, quantize=True):
    """Roofline estimate of one MBConv block forward (make_lat_lut_tpu.py's
    analytic_block_ms)."""
    out_res = (res + 2 * (k // 2) - k) // stride + 1
    mc_q = _round_up(mc, 128) if quantize else mc
    cin_q = _round_up(cin, 128) if quantize else cin
    cout_q = _round_up(cout, 128) if quantize else cout

    flops = 0.0
    if mc > cin:
        flops += 2 * res * res * cin_q * mc_q
    flops += 2 * out_res * out_res * k * k * mc
    if se > 0:
        flops += 2 * (mc_q * se + se * mc_q)
    flops += 2 * out_res * out_res * mc_q * cout_q
    flops *= batch

    bytes_ = batch * (res * res * cin + out_res * out_res * cout
                      + (2 + 2) * out_res * out_res * mc) * dtype_bytes
    bytes_ += (cin * mc + k * k * mc + mc * cout + 2 * mc * se) * dtype_bytes

    t = max(flops / peak_flops, bytes_ / peak_bw) + overhead
    return t * 1000.0


def analytic_vit_ms(res, cin, cout, stride, mc, batch=32, dtype_bytes=2,
                    peak_flops=ANALYTIC_PEAK_FLOPS, peak_bw=ANALYTIC_PEAK_BW,
                    overhead=ANALYTIC_OVERHEAD_S):
    """Roofline estimate of one ViT block forward of the hybrid space
    (make_lat_lut_tpu.py's analytic_vit_ms): patch-merge projection, QKV
    and out projections, attention and MLP."""
    out_res = res // stride if stride > 1 else res
    t = out_res * out_res
    c_q = _round_up(cout, 128)
    mc_q = _round_up(mc, 128)
    flops = 0.0
    if stride > 1 or cin != cout:
        flops += 2 * t * _round_up(cin, 128) * c_q
    flops += 2 * t * c_q * 3 * c_q            # qkv
    flops += 2 * 2 * t * t * c_q              # q.k^T + attn.v
    flops += 2 * t * c_q * c_q                # out proj
    flops += 2 * t * c_q * mc_q * 2           # mlp in + out
    flops *= batch
    bytes_ = batch * t * (cin + 6 * cout + 2 * mc) * dtype_bytes
    bytes_ += (cin * cout + 4 * cout * cout + 2 * cout * mc) * dtype_bytes
    return (max(flops / peak_flops, bytes_ / peak_bw) + overhead) * 1000.0


def build_space_analytic_lut(sp, batch=32, scale=1.0):
    """Analytic LUT for a make_space namespace: one entry per unique block
    key over mc 1..mask length, and a small constant 'base'
    (make_lat_lut_tpu.py's build_space_analytic_lut)."""
    keys = sp.build_lat_lookup_key_dddict()
    masks = sp.build_mc_mask_dddict()
    max_mc_by_key = {}
    for stage in keys:
        for block in keys[stage]:
            for op_idx, key in keys[stage][block].items():
                mm = int(masks[stage][block][op_idx].shape[0])
                max_mc_by_key[key] = max(max_mc_by_key.get(key, 0), mm)
    lut = OrderedDict()
    lut["base"] = 0.01 * scale
    for key, max_mc in max_mc_by_key.items():
        parts = key.split("_")
        res, cin, se, cout = (int(parts[1]), int(parts[2]), int(parts[3]),
                              int(parts[4]))
        k, stride = int(parts[5][1:]), int(parts[6][1:])
        lut[key] = OrderedDict(
            (mc, analytic_block_ms(res, cin, se, cout, k, stride, mc,
                                   batch) * scale)
            for mc in range(1, max_mc + 1))
    return lut
