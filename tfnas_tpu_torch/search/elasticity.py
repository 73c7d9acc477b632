"""Elasticity-scaling engine: post-epoch width shrink/expand against the
latency LUT.

The port's copy of tfnas_tpu/search/elasticity.py (reference
train_search.py:261-307 and 465-532).
This is deliberately plain Python over the LUT dict — it runs once per epoch
off the device; only the resulting masks/latency vectors go back to the
step functions as data.
"""

from __future__ import annotations

import copy

import numpy as np

from ..cost.lut import get_lookup_latency


def bound_clip(mc_num, max_mc_num):
    """Clamp mc into [max//2, max]; switch=False when pinned at a bound
    (train_search.py:519-532)."""
    min_mc_num = max_mc_num // 2
    if mc_num <= min_mc_num:
        return min_mc_num, False
    if mc_num >= max_mc_num:
        return max_mc_num, False
    return mc_num, True


def fit_mc_num_by_latency(parsed_arch, mc_num_dddict, mc_maxnum_dddict,
                          lat_lookup_key_dddict, lat_lookup, target_lat,
                          stages, sign):
    """Proportional +-ratio stepping of every chosen op's mid channels until
    the LUT latency crosses target_lat (train_search.py:478-516).

    sign=+1 expands, sign=-1 shrinks. Steps are proportional to each block's
    mc relative to the smallest chosen mc; blocks pinned at [max//2, max]
    stop switching and the loop ends when all are pinned or the target is
    crossed."""
    assert sign in (-1, 1)
    lat = get_lookup_latency(parsed_arch, mc_num_dddict,
                             lat_lookup_key_dddict, lat_lookup)

    parsed_mc_num_list = []
    parsed_mc_maxnum_list = []
    for stage in stages:
        for block in parsed_arch[stage]:
            op_idx = parsed_arch[stage][block]
            parsed_mc_num_list.append(mc_num_dddict[stage][block][op_idx])
            parsed_mc_maxnum_list.append(mc_maxnum_dddict[stage][block][op_idx])

    min_parsed_mc_num = min(parsed_mc_num_list)
    parsed_mc_ratio_list = [int(round(x / min_parsed_mc_num))
                            for x in parsed_mc_num_list]
    parsed_mc_bound_switches = [True] * len(parsed_mc_ratio_list)

    new_mc_num_dddict = copy.deepcopy(mc_num_dddict)
    new_lat = lat

    while any(parsed_mc_bound_switches) and (sign * new_lat <= sign * target_lat):
        mc_num_dddict = copy.deepcopy(new_mc_num_dddict)
        lat = new_lat
        list_idx = 0
        for stage in stages:
            for block in parsed_arch[stage]:
                op_idx = parsed_arch[stage][block]
                new_mc_num = (mc_num_dddict[stage][block][op_idx]
                              + sign * parsed_mc_ratio_list[list_idx])
                new_mc_num, switch = bound_clip(
                    new_mc_num, parsed_mc_maxnum_list[list_idx])
                new_mc_num_dddict[stage][block][op_idx] = new_mc_num
                parsed_mc_bound_switches[list_idx] = switch
                list_idx += 1
        new_lat = get_lookup_latency(parsed_arch, new_mc_num_dddict,
                                     lat_lookup_key_dddict, lat_lookup)

    if sign == -1:
        # shrink keeps the post-crossing (under-target) widths
        mc_num_dddict = copy.deepcopy(new_mc_num_dddict)
        lat = new_lat

    return mc_num_dddict, lat


def shrink_or_expand(parsed_arch, mc_num_dddict, mc_maxnum_dddict,
                     lat_lookup_key_dddict, lat_lookup, target_lat, log=None):
    """The progressive post-epoch schedule (train_search.py:262-290):
    adjust all stages toward the target, then re-expand from stage2..6,
    3..6, ... 6..6. Returns (mc_num_dddict, before_lat, after_lat)."""
    info = log or (lambda *a: None)
    before_lat = get_lookup_latency(parsed_arch, mc_num_dddict,
                                    lat_lookup_key_dddict, lat_lookup)
    # the progressive schedule spans whatever stages the space has (6 for
    # the reference space; reduced make_space fixtures have fewer)
    n_stages = len(parsed_arch)
    if before_lat > target_lat:
        info("Shrinking......")
        stages = [f"stage{x}" for x in range(1, n_stages + 1)]
        mc_num_dddict, after_lat = fit_mc_num_by_latency(
            parsed_arch, mc_num_dddict, mc_maxnum_dddict,
            lat_lookup_key_dddict, lat_lookup, target_lat, stages, sign=-1)
        for start in range(2, n_stages + 1):
            stages = [f"stage{x}" for x in range(start, n_stages + 1)]
            mc_num_dddict, after_lat = fit_mc_num_by_latency(
                parsed_arch, mc_num_dddict, mc_maxnum_dddict,
                lat_lookup_key_dddict, lat_lookup, target_lat, stages, sign=1)
    elif before_lat < target_lat:
        info("Expanding......")
        stages = [f"stage{x}" for x in range(1, n_stages + 1)]
        mc_num_dddict, after_lat = fit_mc_num_by_latency(
            parsed_arch, mc_num_dddict, mc_maxnum_dddict,
            lat_lookup_key_dddict, lat_lookup, target_lat, stages, sign=1)
        for start in range(2, n_stages + 1):
            stages = [f"stage{x}" for x in range(start, n_stages + 1)]
            mc_num_dddict, after_lat = fit_mc_num_by_latency(
                parsed_arch, mc_num_dddict, mc_maxnum_dddict,
                lat_lookup_key_dddict, lat_lookup, target_lat, stages, sign=1)
    else:
        info("No operation")
        after_lat = before_lat
    return mc_num_dddict, before_lat, after_lat


def rewrite_masks_by_l1(parsed_arch, mc_num_dddict, mc_mask_dddict, params):
    """Rewrite the channel masks of the parsed ops whose width changed,
    keeping the top-mc channels by depthwise-kernel L1 norm.

    `params` is the port's supernet tree: depth kernels are stacked OIHW
    [8, W, 1, 5, 5]. Each kernel is brought to the JAX package's
    [5, 5, 1, W] layout before the sum, so the norms, and the order of
    channels with near-equal norms, are the JAX package's. A parsed ViT
    candidate (op 8 of the hybrid space) ranks its MLP hidden units by the
    L1 norm of their mlp_in columns. Mutates and returns mc_mask_dddict."""
    for stage in parsed_arch:
        for block in parsed_arch[stage]:
            op_idx = parsed_arch[stage][block]
            mask = np.asarray(mc_mask_dddict[stage][block][op_idx])
            mc_num = mc_num_dddict[stage][block][op_idx]
            if mc_num != int(round(float(mask.sum()))):
                bp = params[stage][block]
                if op_idx >= len(bp["depth"]["kernel"]):
                    # the hybrid space's ViT candidate: MLP hidden units
                    # ranked by the L1 norm of their mlp_in columns
                    # ([in, out] in both packages)
                    kernel = bp["vit"]["mlp_in"]["kernel"]
                    l1 = np.abs(kernel.detach().cpu().numpy()).sum(axis=0)
                else:
                    kernel = np.ascontiguousarray(np.transpose(
                        bp["depth"]["kernel"][op_idx].detach().cpu().numpy(),
                        (2, 3, 1, 0)))
                    l1 = np.abs(kernel[..., :mask.shape[0]]).sum(
                        axis=(0, 1, 2))
                order_desc = np.argsort(l1)[::-1][:mc_num]
                new_mask = np.zeros_like(mask)
                new_mask[order_desc] = 1.0
                mc_mask_dddict[stage][block][op_idx] = new_mask
    return mc_mask_dddict
