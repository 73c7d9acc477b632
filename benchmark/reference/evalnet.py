"""Plain PyTorch fixed-architecture TF-NAS network (a model.config), the
reference of the retrain and serving cells: a frozen copy of the port's
eval network with its MBConv blocks, the drop-connect schedule, the
drop-connect and dropout draws and the forward, BN unfolded."""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from .nn import layer_from_config

STAGES = ["stage1", "stage2", "stage3", "stage4", "stage5", "stage6"]


class EvalNet:
    def __init__(self, model_config, num_classes, dropout_rate=0.0,
                 drop_connect_rate=0.0):
        self.num_classes = num_classes
        self.first_stem = layer_from_config(model_config["first_stem"])
        blocks = [layer_from_config(model_config["second_stem"])]
        self.stage_sizes = []
        for st in STAGES:
            cfgs = model_config.get(st, [])
            blocks += [layer_from_config(c) for c in cfgs]
            self.stage_sizes.append((st, len(cfgs)))
        count = len(blocks)
        # drop-connect rate * idx / count, the second stem being the first
        self.blocks = [dataclasses.replace(
            b, drop_connect_rate=drop_connect_rate * (i + 1) / count)
            for i, b in enumerate(blocks)]
        self.feature_mix = layer_from_config(model_config["feature_mix_layer"])
        cls_cfg = dict(model_config["classifier"], out_features=num_classes)
        self.classifier = layer_from_config(cls_cfg)
        self.dropout_rate = dropout_rate

    def _names(self):
        """(stage key, block key or None) of each block, in order."""
        out = [("second_stem", None)]
        for st, n in self.stage_sizes:
            out += [(st, f"block{i + 1}") for i in range(n)]
        return out

    def init(self, pool):
        """(params, bn_state) in the port's tree layout."""
        params, state = {}, {}
        params["first_stem"], state["first_stem"] = self.first_stem.init(pool)
        for (st, bk), b in zip(self._names(), self.blocks):
            p, s = b.init(pool)
            if bk is None:
                params[st], state[st] = p, s
            else:
                params.setdefault(st, {})[bk] = p
                state.setdefault(st, {})[bk] = s
        for st, n in self.stage_sizes:
            params.setdefault(st, {})
            state.setdefault(st, {})
        # the port's key order: stems, stages, head
        order = ["first_stem", "second_stem"] + [s for s, _ in
                                                 self.stage_sizes]
        params = {k: params[k] for k in order}
        state = {k: state[k] for k in order}
        params["feature_mix_layer"], state["feature_mix_layer"] = \
            self.feature_mix.init(pool)
        params["classifier"], state["classifier"] = self.classifier.init(pool)
        return params, state

    def draw_keep(self, n, generator):
        """Per block floor(keep_prob + U[0, 1)) [N] (None where nothing is
        dropped), then the [N, features] dropout mask (None at rate 0)."""
        dev = generator.device
        keep = []
        for b in self.blocks:
            if b.drop_connect_rate > 0.0 and b.has_residual:
                u = torch.rand((n,), generator=generator, device=dev)
                keep.append(torch.floor((1.0 - b.drop_connect_rate) + u))
            else:
                keep.append(None)
        if self.dropout_rate > 0.0:
            u = torch.rand((n, self.feature_mix.out_channels),
                           generator=generator, device=dev)
            keep.append(u < 1.0 - self.dropout_rate)
        else:
            keep.append(None)
        return keep

    def apply(self, params, state, x, *, training=False, keep=None):
        """(logits, new_state) of [N, H, W, 3] x. Training recomputes every
        block's activations in the backward: the same function, and a
        peak that fits at a global batch."""
        keep = keep if keep is not None else [None] * (len(self.blocks) + 1)
        new_state = {}
        x, new_state["first_stem"] = self.first_stem.apply(
            params["first_stem"], state["first_stem"], x.permute(0, 3, 1, 2),
            training=training)
        for i, ((st, bk), b) in enumerate(zip(self._names(), self.blocks)):
            p = params[st] if bk is None else params[st][bk]
            s0 = state[st] if bk is None else state[st][bk]
            fn = functools.partial(b.apply, training=training, keep=keep[i])
            if training:
                x, s = checkpoint(fn, p, s0, x, use_reentrant=False)
            else:
                x, s = fn(p, s0, x)
            if bk is None:
                new_state[st] = s
            else:
                new_state.setdefault(st, {})[bk] = s
        x, new_state["feature_mix_layer"] = self.feature_mix.apply(
            params["feature_mix_layer"], state["feature_mix_layer"], x,
            training=training)
        x = x.mean(dim=(2, 3))
        if self.dropout_rate > 0.0 and training and keep[-1] is not None:
            x = torch.where(keep[-1], x / (1.0 - self.dropout_rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        x, new_state["classifier"] = self.classifier.apply(
            params["classifier"], state["classifier"], x)
        return x, new_state
