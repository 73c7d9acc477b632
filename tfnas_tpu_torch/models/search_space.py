"""TF-NAS search-space definition as static data (the port's own copy of
tfnas_tpu/models/search_space.py, value-identical to it).

Rather than scattering the macro skeleton across constructors
(model_search.py:219-277) and hand-enumerating 390 lines of width masks and
66 LUT keys (tools/config.py), the whole space is derived here from one
table. The derived structures are value-identical to the reference's:

- PRIMITIVES / op->SE mapping       model_search.py:7-29, model_eval.py:6-28
- stage skeleton (ics/ocs/ss/acts)  model_search.py:221-274
- mc_mask_dddict                    tools/config.py:4-197
- lat_lookup_key_dddict             tools/config.py:200-393
- LUT key string format             model_search.py:99-107

Ops are indexed 0..7; even indices are e3 (mask length 4*ic, initially 3*ic
live), odd are e6 (mask length 8*ic, initially 6*ic live); indices >=4 carry
an SE module with se_channels = ic (even) or 2*ic (odd).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..ops.layers import MBInvertedResBlock

PRIMITIVES = [
    "MBI_k3_e3",
    "MBI_k3_e6",
    "MBI_k5_e3",
    "MBI_k5_e6",
    "MBI_k3_e3_se",
    "MBI_k3_e6_se",
    "MBI_k5_e3_se",
    "MBI_k5_e6_se",
]

NUM_OPS = len(PRIMITIVES)

# Per-op static attributes, index-aligned with PRIMITIVES.
OP_KERNEL = [3, 3, 5, 5, 3, 3, 5, 5]
OP_EXPAND = [3, 6, 3, 6, 3, 6, 3, 6]        # initial live expansion
OP_MAX_EXPAND = [4, 8, 4, 8, 4, 8, 4, 8]    # mask length / max width
OP_SE_MULT = [0, 0, 0, 0, 1, 2, 1, 2]       # se_channels = mult * ic


def make_op(op_idx, ic, mc, oc, stride, affine, act_func):
    """Instantiate candidate op `op_idx` (the OPS lambdas,
    model_search.py:19-29)."""
    return MBInvertedResBlock(
        in_channels=ic,
        mid_channels=mc,
        se_channels=OP_SE_MULT[op_idx] * ic,
        out_channels=oc,
        kernel_size=OP_KERNEL[op_idx],
        stride=stride,
        affine=affine,
        act_func=act_func,
    )


# Macro skeleton (model_search.py:219-277 / model_eval.py:42-84):
# stem: 3x3 s2 conv 3->32 (relu), fixed MBConv(32, 32, se8, 16, k3, s1, relu)
# head: 1x1 conv 320->1280 (swish), GAP, FC 1280->num_classes.
STEM_CONV = dict(in_channels=3, out_channels=32, kernel_size=3, stride=2,
                 act_func="relu")
SECOND_STEM = dict(in_channels=32, mid_channels=32, se_channels=8,
                   out_channels=16, kernel_size=3, stride=1, act_func="relu")
HEAD_CONV = dict(in_channels=320, out_channels=1280, kernel_size=1, stride=1,
                 act_func="swish")
HEAD_FEATURES = 1280

STAGE_NAMES = ["stage1", "stage2", "stage3", "stage4", "stage5", "stage6"]

STAGE_SPECS = OrderedDict([
    ("stage1", dict(ics=[16, 24], ocs=[24, 24], ss=[2, 1],
                    acts=["relu", "relu"], stage_type=1)),
    ("stage2", dict(ics=[24, 40, 40], ocs=[40, 40, 40], ss=[2, 1, 1],
                    acts=["swish"] * 3, stage_type=2)),
    ("stage3", dict(ics=[40, 80, 80, 80], ocs=[80, 80, 80, 80], ss=[2, 1, 1, 1],
                    acts=["swish"] * 4, stage_type=3)),
    ("stage4", dict(ics=[80, 112, 112, 112], ocs=[112, 112, 112, 112],
                    ss=[1, 1, 1, 1], acts=["swish"] * 4, stage_type=3)),
    ("stage5", dict(ics=[112, 192, 192, 192], ocs=[192, 192, 192, 192],
                    ss=[2, 1, 1, 1], acts=["swish"] * 4, stage_type=3)),
    ("stage6", dict(ics=[192], ocs=[320], ss=[1], acts=["swish"],
                    stage_type=0)),
])

# Per-stage depth-candidate count (MixedStage.num_res, model_search.py:131-132):
# start_res is 1 for every stage as configured (first block always has
# stride 2 or ic != oc), so num_res == number of blocks.
STAGE_DEPTHS = {name: len(spec["ics"]) for name, spec in STAGE_SPECS.items()}

TOTAL_BLOCKS = sum(STAGE_DEPTHS.values())  # 18 searchable blocks

SEARCH_INPUT_SIZE = 224


def block_names(stage):
    return [f"block{i + 1}" for i in range(STAGE_DEPTHS[stage])]


def _compute_input_resolutions(input_size=SEARCH_INPUT_SIZE):
    """Input spatial size of every searchable block at 224x224.

    The LUT key uses the block's *input* resolution (x.size(-1) before the
    block runs, model_eval.py:134-215)."""
    res = input_size // STEM_CONV["stride"]  # first_stem s2: 224 -> 112
    # second_stem is stride 1.
    out = OrderedDict()
    for stage, spec in STAGE_SPECS.items():
        out[stage] = []
        for s in spec["ss"]:
            out[stage].append(res)
            res = res // s if s > 1 else res
    return out


BLOCK_INPUT_RES = _compute_input_resolutions()


def lut_key(op_idx, res, ic, oc, stride, act_func):
    """LUT key string (model_search.py:99-107):
    MBInvertedResBlock_{res}_{cin}_{se}_{cout}_k{K}_s{S}_{act}"""
    se = OP_SE_MULT[op_idx] * ic
    return "MBInvertedResBlock_{}_{}_{}_{}_k{}_s{}_{}".format(
        res, ic, se, oc, OP_KERNEL[op_idx], stride, act_func)


def build_mc_mask_dddict():
    """Initial width masks (tools/config.py:4-197): per stage/block/op a 0/1
    float vector of length ic*4 (e3) or ic*8 (e6) whose first ic*3 / ic*6
    entries are 1. Stored as numpy float32 arrays."""
    dddict = OrderedDict()
    for stage, spec in STAGE_SPECS.items():
        dddict[stage] = OrderedDict()
        for b, ic in enumerate(spec["ics"]):
            block = f"block{b + 1}"
            dddict[stage][block] = OrderedDict()
            for op_idx in range(NUM_OPS):
                max_mc = ic * OP_MAX_EXPAND[op_idx]
                live = ic * OP_EXPAND[op_idx]
                mask = np.zeros((max_mc,), np.float32)
                mask[:live] = 1.0
                dddict[stage][block][op_idx] = mask
    return dddict


def build_lat_lookup_key_dddict():
    """LUT keys per stage/block/op (tools/config.py:200-393)."""
    dddict = OrderedDict()
    for stage, spec in STAGE_SPECS.items():
        dddict[stage] = OrderedDict()
        for b in range(len(spec["ics"])):
            block = f"block{b + 1}"
            res = BLOCK_INPUT_RES[stage][b]
            dddict[stage][block] = OrderedDict()
            for op_idx in range(NUM_OPS):
                dddict[stage][block][op_idx] = lut_key(
                    op_idx, res, spec["ics"][b], spec["ocs"][b],
                    spec["ss"][b], spec["acts"][b])
    return dddict


mc_mask_dddict = build_mc_mask_dddict()
lat_lookup_key_dddict = build_lat_lookup_key_dddict()


# -- parameterized spaces ---------------------------------------------------

def make_space(stage_specs, *, stem_conv, second_stem, head_conv,
               head_features, input_size=SEARCH_INPUT_SIZE):
    """Build a space namespace with the same attribute surface as this
    module (STAGE_SPECS, STAGE_NAMES, STAGE_DEPTHS, TOTAL_BLOCKS,
    BLOCK_INPUT_RES, stem/head specs, op tables, mask/key builders) so
    SuperNetwork can run over reduced spaces — fast-compiling test fixtures
    and small-shape multichip dryruns — without touching the reference
    space. Op-level constants (the 8 MBConv primitives) are shared: a space
    varies the macro skeleton, not the candidate set."""
    import types

    sp = types.SimpleNamespace(
        PRIMITIVES=PRIMITIVES, NUM_OPS=NUM_OPS, OP_KERNEL=OP_KERNEL,
        OP_EXPAND=OP_EXPAND, OP_MAX_EXPAND=OP_MAX_EXPAND,
        OP_SE_MULT=OP_SE_MULT, make_op=make_op, lut_key=lut_key,
        STEM_CONV=dict(stem_conv), SECOND_STEM=dict(second_stem),
        HEAD_CONV=dict(head_conv), HEAD_FEATURES=head_features,
        STAGE_SPECS=OrderedDict(stage_specs),
        SEARCH_INPUT_SIZE=input_size,
    )
    sp.STAGE_NAMES = list(sp.STAGE_SPECS)
    sp.STAGE_DEPTHS = {name: len(spec["ics"])
                       for name, spec in sp.STAGE_SPECS.items()}
    sp.TOTAL_BLOCKS = sum(sp.STAGE_DEPTHS.values())
    sp.block_names = lambda stage: [
        f"block{i + 1}" for i in range(sp.STAGE_DEPTHS[stage])]

    res = input_size // sp.STEM_CONV["stride"]
    sp.BLOCK_INPUT_RES = OrderedDict()
    for stage, spec in sp.STAGE_SPECS.items():
        sp.BLOCK_INPUT_RES[stage] = []
        for s in spec["ss"]:
            sp.BLOCK_INPUT_RES[stage].append(res)
            res = res // s if s > 1 else res

    def _build_masks():
        dddict = OrderedDict()
        for stage, spec in sp.STAGE_SPECS.items():
            dddict[stage] = OrderedDict()
            for b, ic in enumerate(spec["ics"]):
                block = f"block{b + 1}"
                dddict[stage][block] = OrderedDict()
                for op_idx in range(NUM_OPS):
                    mask = np.zeros((ic * OP_MAX_EXPAND[op_idx],), np.float32)
                    mask[:ic * OP_EXPAND[op_idx]] = 1.0
                    dddict[stage][block][op_idx] = mask
        return dddict

    def _build_keys():
        dddict = OrderedDict()
        for stage, spec in sp.STAGE_SPECS.items():
            dddict[stage] = OrderedDict()
            for b in range(len(spec["ics"])):
                block = f"block{b + 1}"
                dddict[stage][block] = OrderedDict()
                for op_idx in range(NUM_OPS):
                    dddict[stage][block][op_idx] = lut_key(
                        op_idx, sp.BLOCK_INPUT_RES[stage][b],
                        spec["ics"][b], spec["ocs"][b], spec["ss"][b],
                        spec["acts"][b])
        return dddict

    sp.build_mc_mask_dddict = _build_masks
    sp.build_lat_lookup_key_dddict = _build_keys
    return sp


def tiny_space(input_size=32):
    """A 2-stage, 3-block space with ic 8/16 — same structure, ~100x less
    compile work than the 18-block reference space. For tests and
    small-shape multichip dryruns."""
    return make_space(
        OrderedDict([
            ("stage1", dict(ics=[8, 16], ocs=[16, 16], ss=[2, 1],
                            acts=["relu", "relu"], stage_type=1)),
            ("stage2", dict(ics=[16], ocs=[24], ss=[1], acts=["swish"],
                            stage_type=0)),
        ]),
        stem_conv=dict(in_channels=3, out_channels=16, kernel_size=3,
                       stride=2, act_func="relu"),
        second_stem=dict(in_channels=16, mid_channels=16, se_channels=4,
                         out_channels=8, kernel_size=3, stride=1,
                         act_func="relu"),
        head_conv=dict(in_channels=24, out_channels=64, kernel_size=1,
                       stride=1, act_func="swish"),
        head_features=64,
        input_size=input_size,
    )
