"""Fixed-architecture TF-NAS networks for retraining and serving
(counterpart of tfnas_tpu/models/eval_net.py).

`EvalNetwork` is built from a parsed architecture (`from_parsed_arch`) or
from a model.config JSON (`from_config`); `config` writes that JSON back
key for key. The network is data (a list of layer objects); `init` builds
the parameter and BN-state trees, `apply` is a function of them. Inputs are
[N, H, W, 3] as in the JAX package; inside, activations are NCHW in
`channels_last` memory.

Randomness enters as arguments: `apply(..., keep=...)` takes the
drop-connect and dropout draws, one entry per block (the second stem first)
and the dropout mask last, the order of the JAX package's key split.
`draw_keep` makes them from a torch.Generator.

The same class builds CoAtNet (arXiv:2106.04803; configs/coatnet2.config)
from its model.config: a ConvLayer stem pair, MBConvPreNorm stages, then
RelTransformerBlock stages, and no feature_mix_layer (the config leaves
the key out: the head is global pool -> classifier). Stages absent from a
config are empty.

With the block spans on (utils/trace.py `enable(blocks=True)`), each
block's apply, and its backward, lies in a device span: `tfnas.block.attn`
for the attention blocks, `tfnas.block.mbconv` for the stems and every
convolutional block.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..ops.attention import RelTransformerBlock, ViTBlock
from ..ops.layers import (ConvLayer, LinearLayer, MBConvPreNorm,
                          MBInvertedResBlock, set_layer_from_config)
from ..utils import trace
from . import hybrid_space as hs
from . import search_space as ss

# blocks with two residual branches (attention, feed-forward): their
# drop-connect draws are a pair
TWO_BRANCH = (ViTBlock, RelTransformerBlock)
DROP_CONNECT_BLOCKS = (MBInvertedResBlock, MBConvPreNorm) + TWO_BRANCH


def traced(block, *args, **kw):
    """block.apply(*args, **kw), its forward and its backward each in the
    block's device span (nothing recorded unless the block spans are
    on)."""
    name = ("tfnas.block.attn" if isinstance(block, TWO_BRANCH)
            else "tfnas.block.mbconv")
    with trace.block_span(name):
        x, state = block.apply(*args, **kw)
    return trace.backward_span(x, name), state


class EvalNetwork:
    """Stem -> stage blocks -> head classifier, fixed architecture."""

    def __init__(self, first_stem, second_stem, stages, feature_mix_layer,
                 classifier, dropout_rate=0.0, drop_connect_rate=0.0):
        self.first_stem = first_stem
        self.second_stem = second_stem
        self.stages = stages  # OrderedDict[stage name -> list of blocks]
        self.feature_mix_layer = feature_mix_layer
        self.classifier = classifier
        self.dropout_rate = dropout_rate
        self.drop_connect_rate = drop_connect_rate
        self._apply_drop_connect_schedule()

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_parsed_arch(cls, num_classes, parsed_arch, mc_num_dddict,
                         dropout_rate=0.0, drop_connect_rate=0.0,
                         space=None):
        """Block op and width chosen by parsed_arch / mc_num_dddict over the
        macro skeleton of `space` (None: the reference TF-NAS space)."""
        sp = space or ss
        stages = OrderedDict()
        for stage, spec in sp.STAGE_SPECS.items():
            blocks = []
            for i, block in enumerate(parsed_arch.get(stage, {})):
                op_idx = parsed_arch[stage][block]
                mc = mc_num_dddict[stage][block][op_idx]
                if op_idx >= ss.NUM_OPS:  # the hybrid space's ViT candidate
                    blocks.append(hs.make_vit_op(
                        (spec["ics"][i], spec["ocs"][i], spec["ss"][i],
                         spec["acts"][i]), mc, affine=True))
                else:
                    blocks.append(sp.make_op(op_idx, spec["ics"][i], mc,
                                             spec["ocs"][i], spec["ss"][i],
                                             True, spec["acts"][i]))
            stages[stage] = blocks
        return cls(
            first_stem=ConvLayer(affine=True, **sp.STEM_CONV),
            second_stem=MBInvertedResBlock(affine=True, **sp.SECOND_STEM),
            stages=stages,
            feature_mix_layer=ConvLayer(affine=True, **sp.HEAD_CONV),
            classifier=LinearLayer(sp.HEAD_FEATURES, num_classes),
            dropout_rate=dropout_rate,
            drop_connect_rate=drop_connect_rate,
        )

    @classmethod
    def from_config(cls, num_classes, model_config, dropout_rate=0.0,
                    drop_connect_rate=0.0):
        """Built from the model.config JSON alone; the classifier's
        out_features becomes num_classes. A config without a
        feature_mix_layer pools the last stage's output straight into the
        classifier."""
        stages = OrderedDict()
        for stage in ss.STAGE_NAMES:
            stages[stage] = [set_layer_from_config(c)
                             for c in model_config.get(stage, [])]
        classifier_config = dict(model_config["classifier"])
        classifier_config["out_features"] = num_classes
        return cls(
            first_stem=set_layer_from_config(model_config["first_stem"]),
            second_stem=set_layer_from_config(model_config["second_stem"]),
            stages=stages,
            feature_mix_layer=set_layer_from_config(
                model_config.get("feature_mix_layer")),
            classifier=set_layer_from_config(classifier_config),
            dropout_rate=dropout_rate,
            drop_connect_rate=drop_connect_rate,
        )

    # -- structure ---------------------------------------------------------

    def _apply_drop_connect_schedule(self):
        """Drop-connect rate * idx / count for the idx-th block, the second
        stem being the first."""
        count = 1 + sum(len(b) for b in self.stages.values())
        idx = 1
        self.second_stem = self._with_dc(
            self.second_stem, self.drop_connect_rate * idx / count)
        new_stages = OrderedDict()
        for stage, blocks in self.stages.items():
            out = []
            for block in blocks:
                idx += 1
                out.append(self._with_dc(
                    block, self.drop_connect_rate * idx / count))
            new_stages[stage] = out
        self.stages = new_stages
        self.block_count = count

    @staticmethod
    def _with_dc(block, rate):
        if isinstance(block, DROP_CONNECT_BLOCKS):
            return dataclasses.replace(block, drop_connect_rate=rate)
        return block

    def iter_blocks(self):
        for stage, blocks in self.stages.items():
            for i, b in enumerate(blocks):
                yield stage, f"block{i + 1}", b

    def _blocks(self):
        """Every block in forward order, the second stem first."""
        return [self.second_stem] + [b for _, _, b in self.iter_blocks()]

    @property
    def config(self):
        """The model.config dict."""
        cfg = {
            "first_stem": self.first_stem.config,
            "second_stem": self.second_stem.config,
        }
        for stage, blocks in self.stages.items():
            cfg[stage] = [b.config for b in blocks]
        if self.feature_mix_layer is not None:
            cfg["feature_mix_layer"] = self.feature_mix_layer.config
        cfg["classifier"] = self.classifier.config
        return cfg

    # -- params / forward --------------------------------------------------

    def init(self, generator):
        params, state = {}, {}
        params["first_stem"], state["first_stem"] = \
            self.first_stem.init(generator)
        params["second_stem"], state["second_stem"] = \
            self.second_stem.init(generator)
        for stage, blocks in self.stages.items():
            sp, st = {}, {}
            for i, block in enumerate(blocks):
                sp[f"block{i + 1}"], st[f"block{i + 1}"] = \
                    block.init(generator)
            params[stage], state[stage] = sp, st
        if self.feature_mix_layer is not None:
            params["feature_mix_layer"], state["feature_mix_layer"] = \
                self.feature_mix_layer.init(generator)
        params["classifier"], state["classifier"] = \
            self.classifier.init(generator)
        return params, state

    def draw_keep(self, n, generator):
        """The random draws of one training forward at batch n: per block,
        floor(keep_prob + U[0, 1)) of shape [N] (a pair of them, one per
        residual branch, for a ViT or relative-attention block; None where
        the block drops nothing), then the [N, features] dropout keep mask
        (None at rate 0)."""
        dev = generator.device

        def draw(rate):
            u = torch.rand((n,), generator=generator, device=dev)
            return torch.floor((1.0 - rate) + u)

        keep = []
        for b in self._blocks():
            rate = getattr(b, "drop_connect_rate", 0.0)
            if rate > 0.0 and isinstance(b, TWO_BRANCH):
                keep.append((draw(rate), draw(rate)))
            elif rate > 0.0 and b.has_residual:
                keep.append(draw(rate))
            else:
                keep.append(None)
        if self.dropout_rate > 0.0:
            feats = self.classifier.in_features
            u = torch.rand((n, feats), generator=generator, device=dev)
            keep.append(u < 1.0 - self.dropout_rate)
        else:
            keep.append(None)
        return keep

    def apply(self, params, state, x, *, training=False, keep=None,
              bn_group=None):
        """Forward of [N, H, W, 3] x. Returns (logits, new_state). keep: the
        draws of `draw_keep` (or the JAX package's, converted); without
        them nothing is dropped. bn_group: the process group of
        cross-replica BN (training only)."""
        new_state = {}
        keep = keep if keep is not None else [None] * (self.block_count + 1)
        x = x.permute(0, 3, 1, 2)
        x, new_state["first_stem"] = traced(
            self.first_stem, params["first_stem"],
            state.get("first_stem", {}), x, training=training,
            bn_group=bn_group)
        second = {"keep": keep[0]} if isinstance(
            self.second_stem, DROP_CONNECT_BLOCKS) else {}
        x, new_state["second_stem"] = traced(
            self.second_stem, params["second_stem"],
            state.get("second_stem", {}), x, training=training,
            bn_group=bn_group, **second)
        r = 1
        for stage, blocks in self.stages.items():
            st = {}
            for i, block in enumerate(blocks):
                bn = f"block{i + 1}"
                x, st[bn] = traced(
                    block, params[stage][bn],
                    state.get(stage, {}).get(bn, {}), x, training=training,
                    keep=keep[r], bn_group=bn_group)
                r += 1
            new_state[stage] = st
        if self.feature_mix_layer is not None:
            x, new_state["feature_mix_layer"] = self.feature_mix_layer.apply(
                params["feature_mix_layer"],
                state.get("feature_mix_layer", {}), x, training=training,
                bn_group=bn_group)
        x = x.mean(dim=(2, 3))  # global average pool
        mask = keep[-1]
        if self.dropout_rate > 0.0 and training and mask is not None:
            x = torch.where(mask, x / (1.0 - self.dropout_rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        x, new_state["classifier"] = self.classifier.apply(
            params["classifier"], state.get("classifier", {}), x,
            training=training, bn_group=bn_group)
        return x, new_state

    # -- analysis ----------------------------------------------------------

    def get_lookup_latency(self, lat_lookup, input_size=224):
        """LUT latency: 'base' plus each block's entry at its mid width;
        resolutions follow the strides, no forward is run."""
        if not lat_lookup:
            return 0.0
        lat = lat_lookup["base"]
        res = input_size // self.first_stem.stride
        for _, _, block in self.iter_blocks():
            if isinstance(block, ViTBlock):
                key = hs.vit_lut_key(res, block.in_channels,
                                     block.out_channels, block.stride,
                                     block.act_func)
            else:
                key = "{}_{}_{}_{}_{}_k{}_s{}_{}".format(
                    block.name, res, block.in_channels, block.se_channels,
                    block.out_channels, block.kernel_size, block.stride,
                    block.act_func)
            lat += lat_lookup[key][block.mid_channels]
            res = res // block.stride if block.stride > 1 else res
        return lat
