"""The hybrid conv/ViT candidate space (the port's copy of
tfnas_tpu/models/hybrid_space.py).

The 8 MBConv candidates of search_space.py at every block site, and a 9th,
the pre-norm transformer block of ops/attention.py, at the sites of the
low-resolution stages 4-6 (14x14 and 7x7 inputs). Its searchable width is
the MLP hidden width, masked over VIT_MAX_EXPAND * oc with VIT_EXPAND * oc
live at the start, so the elasticity rules of the conv candidates apply
unchanged. Its LUT keys follow the same 'key -> {width: ms}' schema.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..ops.attention import ViTBlock
from . import search_space as ss

VIT_OP_IDX = ss.NUM_OPS          # 8
NUM_OPS = ss.NUM_OPS + 1         # 9
VIT_STAGES = ("stage4", "stage5", "stage6")
VIT_NUM_HEADS = 4
VIT_EXPAND = 3                   # initial live MLP ratio (vs oc)
VIT_MAX_EXPAND = 4               # mask length / max MLP ratio (vs oc)

PRIMITIVES = ss.PRIMITIVES + ["ViT_h4"]

# the reference skeleton, so that this module serves as a space namespace
# (parse_architecture, the search driver) as search_space does
STAGE_NAMES = ss.STAGE_NAMES
STAGE_SPECS = ss.STAGE_SPECS
STAGE_DEPTHS = ss.STAGE_DEPTHS
TOTAL_BLOCKS = ss.TOTAL_BLOCKS


def block_has_vit(stage):
    return stage in VIT_STAGES


def valid_op_mask():
    """[TOTAL_BLOCKS, 9] float 0/1: the candidates each block offers (ops
    0-7 everywhere, the ViT candidate in VIT_STAGES)."""
    m = np.zeros((ss.TOTAL_BLOCKS, NUM_OPS), np.float32)
    m[:, :ss.NUM_OPS] = 1.0
    g = 0
    for stage, spec in ss.STAGE_SPECS.items():
        for _ in spec["ics"]:
            if block_has_vit(stage):
                m[g, VIT_OP_IDX] = 1.0
            g += 1
    return m


def make_vit_op(stage_spec_entry, mc, *, affine, drop_connect_rate=0.0):
    """The ViT candidate of a block site (ic, oc, stride, act)."""
    ic, oc, stride, act = stage_spec_entry
    return ViTBlock(in_channels=ic, mid_channels=mc, out_channels=oc,
                    num_heads=VIT_NUM_HEADS, stride=stride, affine=affine,
                    act_func=act, drop_connect_rate=drop_connect_rate)


def vit_lut_key(res, ic, oc, stride, act):
    """LUT key of the ViT candidate (key -> {mlp hidden width: ms})."""
    return "ViTBlock_{}_{}_h{}_{}_s{}_{}".format(
        res, ic, VIT_NUM_HEADS, oc, stride, act)


def build_mc_mask_dddict():
    """Width-mask registry: ops 0-7 as search_space's; op 8, where offered,
    masks the MLP hidden width [VIT_MAX_EXPAND * oc], VIT_EXPAND * oc
    live."""
    dddict = ss.build_mc_mask_dddict()
    for stage, spec in ss.STAGE_SPECS.items():
        if not block_has_vit(stage):
            continue
        for b, oc in enumerate(spec["ocs"]):
            mask = np.zeros((oc * VIT_MAX_EXPAND,), np.float32)
            mask[:oc * VIT_EXPAND] = 1.0
            dddict[stage][f"block{b + 1}"][VIT_OP_IDX] = mask
    return dddict


def build_lat_lookup_key_dddict():
    """LUT-key registry: ops 0-7 as search_space's; op 8 vit_lut_key."""
    dddict = ss.build_lat_lookup_key_dddict()
    for stage, spec in ss.STAGE_SPECS.items():
        if not block_has_vit(stage):
            continue
        for b in range(len(spec["ics"])):
            dddict[stage][f"block{b + 1}"][VIT_OP_IDX] = vit_lut_key(
                ss.BLOCK_INPUT_RES[stage][b], spec["ics"][b],
                spec["ocs"][b], spec["ss"][b], spec["acts"][b])
    return dddict


def vit_sites():
    """OrderedDict global_idx -> (stage, block, (ic, oc, stride, act))."""
    out = OrderedDict()
    g = 0
    for stage, spec in ss.STAGE_SPECS.items():
        for b in range(len(spec["ics"])):
            if block_has_vit(stage):
                out[g] = (stage, f"block{b + 1}",
                          (spec["ics"][b], spec["ocs"][b], spec["ss"][b],
                           spec["acts"][b]))
            g += 1
    return out


def vit_lut_sites():
    """The distinct (res, cin, cout, stride, act) of the ViT sites, in
    block order: one LUT key each."""
    sites = []
    for stage, block, (ic, oc, stride, act) in vit_sites().values():
        t = (ss.BLOCK_INPUT_RES[stage][int(block[len("block"):]) - 1], ic,
             oc, stride, act)
        if t not in sites:
            sites.append(t)
    return sites
