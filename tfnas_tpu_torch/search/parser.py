"""Architecture parsing: search checkpoint -> deployable architecture
(the port's copy of tfnas_tpu/search/parser.py; numpy only).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..models import search_space as ss
from ..utils.checkpoint import load_checkpoint


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - np.max(x))
    return e / e.sum()


def get_op_and_depth_weights(ckpt_or_path):
    """exp(log_alphas) per block and softmax(betas) per stage
    (parsing_model.py:23-41).

    Accepts a checkpoint path, a loaded checkpoint dict, or a live
    arch-params dict with 'log_alphas' [18, NUM_OPS] and 'betas'
    {stage: [depth]}.
    """
    if isinstance(ckpt_or_path, str):
        ckpt = load_checkpoint(ckpt_or_path)
    else:
        ckpt = ckpt_or_path
    arch = ckpt.get("arch_params", ckpt)
    log_alphas = np.asarray(arch["log_alphas"])
    betas = arch["betas"]
    # stage names come from the betas dict itself (sorted by index) so
    # reduced spaces (search_space.tiny_space) parse with the same code
    stage_names = sorted(betas, key=lambda s: int(s[len("stage"):]))
    op_weights = [np.exp(log_alphas[b]) for b in range(log_alphas.shape[0])]
    depth_weights = [_softmax(np.asarray(betas[stage]))
                     for stage in stage_names]
    return op_weights, depth_weights


def parse_architecture(op_weights, depth_weights, space=None):
    """argmax op per block; argmax+1 depth per stage; trailing blocks deleted
    (parsing_model.py:44-73). space: macro-skeleton namespace; None = the
    reference TF-NAS space."""
    sp = space or ss

    def _blocks(stage):
        if hasattr(sp, "block_names"):
            return sp.block_names(stage)
        return [f"block{i + 1}" for i in range(sp.STAGE_DEPTHS[stage])]

    parsed_arch = OrderedDict(
        (stage, OrderedDict((block, -1) for block in _blocks(stage)))
        for stage in sp.STAGE_NAMES)

    stages, blocks = [], []
    for stage in parsed_arch:
        for block in parsed_arch[stage]:
            stages.append(stage)
            blocks.append(block)

    op_max_indexes = [int(np.argmax(x)) for x in op_weights]
    for stage, block, op_max_index in zip(stages, blocks, op_max_indexes):
        parsed_arch[stage][block] = op_max_index

    depth_max_indexes = [int(np.argmax(x)) + 1 for x in depth_weights]
    for stage, depth_max_index in zip(parsed_arch, depth_max_indexes):
        n_blocks = len(parsed_arch[stage])
        for block_index in range(depth_max_index + 1, n_blocks + 1):
            block = f"block{block_index}"
            if block in parsed_arch[stage]:
                del parsed_arch[stage][block]

    return parsed_arch


def get_mc_num_dddict(mc_mask_dddict, is_max=False):
    """Mask -> live channel count (or mask length when is_max)
    (parsing_model.py:76-88)."""
    mc_num_dddict = OrderedDict()
    for stage in mc_mask_dddict:
        mc_num_dddict[stage] = OrderedDict()
        for block in mc_mask_dddict[stage]:
            mc_num_dddict[stage][block] = OrderedDict()
            for op_idx in mc_mask_dddict[stage][block]:
                mask = np.asarray(mc_mask_dddict[stage][block][op_idx])
                if is_max:
                    mc_num_dddict[stage][block][op_idx] = int(mask.shape[0])
                else:
                    mc_num_dddict[stage][block][op_idx] = int(round(float(mask.sum())))
    return mc_num_dddict
