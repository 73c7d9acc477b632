"""Plain PyTorch TF-NAS supernet: the search space built from a
configuration's sizes, the stacked candidate parameters, the sampled-pair
and soft forwards, the width masks and the latency vectors.

A frozen copy of the port's supernet arithmetic with its options left out
and the fused depthwise kernel written as separate operations: mask ->
BN -> act -> 5x5 depthwise -> BN -> act. Every block stores its 8
candidates stacked at one canonical shape (k3 taps zero-padded to 5x5, e3
widths padded to the e6 width W = 8 * ic, zero SE weights where a candidate
has none); width elasticity is channel masks over those shapes. Inputs are
[N, H, W, C]; inside, NCHW.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .nn import (ConvLayer, LinearLayer, MBInvertedResBlock, apply_act,
                 batch_norm, conv2d, rnd)

NUM_OPS = 8
OP_KERNEL = [3, 3, 5, 5, 3, 3, 5, 5]
OP_EXPAND = [3, 6, 3, 6, 3, 6, 3, 6]
OP_MAX_EXPAND = [4, 8, 4, 8, 4, 8, 4, 8]
OP_SE_MULT = [0, 0, 0, 0, 1, 2, 1, 2]
KMAX = 5


@dataclasses.dataclass(frozen=True)
class Site:
    stage: str
    block: str
    global_idx: int
    ic: int
    oc: int
    stride: int
    act: str
    res: int  # input resolution

    @property
    def width(self):
        return self.ic * max(OP_MAX_EXPAND)

    @property
    def se_width(self):
        return self.ic * max(OP_SE_MULT)

    @property
    def has_residual(self):
        return self.ic == self.oc and self.stride == 1


class Space:
    """The macro skeleton of a configuration's `space` entry: stems, stages
    of searchable blocks, head."""

    def __init__(self, spec, image_size):
        self.stem = dict(spec["stem_conv"])
        self.second_stem = dict(spec["second_stem"])
        self.head = dict(spec["head_conv"])
        self.head_features = int(spec["head_features"])
        self.stages = OrderedDict((k, v) for k, v in spec["stages"].items())
        self.image_size = image_size
        self.sites, g = [], 0
        res = image_size // self.stem["stride"]
        for stage, st in self.stages.items():
            for i in range(len(st["ics"])):
                self.sites.append(Site(stage, f"block{i + 1}", g,
                                       st["ics"][i], st["ocs"][i],
                                       st["ss"][i], st["acts"][i], res))
                res = res // st["ss"][i] if st["ss"][i] > 1 else res
                g += 1

    def depth(self, stage):
        return len(self.stages[stage]["ics"])

    def mc_mask_dddict(self):
        """Initial width masks: length ic*4 (e3) / ic*8 (e6), the first
        ic*3 / ic*6 entries live."""
        out = OrderedDict()
        for s in self.sites:
            d = out.setdefault(s.stage, OrderedDict()).setdefault(
                s.block, OrderedDict())
            for o in range(NUM_OPS):
                m = np.zeros((s.ic * OP_MAX_EXPAND[o],), np.float32)
                m[:s.ic * OP_EXPAND[o]] = 1.0
                d[o] = m
        return out

    def lut_keys(self):
        out = OrderedDict()
        for s in self.sites:
            d = out.setdefault(s.stage, OrderedDict()).setdefault(
                s.block, OrderedDict())
            for o in range(NUM_OPS):
                d[o] = "MBInvertedResBlock_{}_{}_{}_{}_k{}_s{}_{}".format(
                    s.res, s.ic, OP_SE_MULT[o] * s.ic, s.oc, OP_KERNEL[o],
                    s.stride, s.act)
        return out


def load_lut(path):
    """A latency table pickle, negative entries clamped to 0."""
    with open(path, "rb") as f:
        lut = pickle.load(f)
    for key, val in lut.items():
        if key != "base":
            for mc in val:
                val[mc] = max(val[mc], 0.0)
    return lut


def lat_vectors(lut, space, mc_mask_dddict):
    """float32 [blocks, 8]: each op's table latency at its live width."""
    keys = space.lut_keys()
    out = np.zeros((len(space.sites), NUM_OPS), np.float32)
    for s in space.sites:
        for o in range(NUM_OPS):
            mc = int(mc_mask_dddict[s.stage][s.block][o].sum())
            out[s.global_idx, o] = lut[keys[s.stage][s.block][o]][mc]
    return out


# -- parameters ---------------------------------------------------------------

def _block_layout(site):
    """{leaf path: (shape, per-op fan-ins, structure mask [8, ...])} of a
    block's stacked candidates."""
    W, SE, ic, oc = site.width, site.se_width, site.ic, site.oc
    wo = [ic * OP_MAX_EXPAND[o] for o in range(NUM_OPS)]
    so = [ic * OP_SE_MULT[o] for o in range(NUM_OPS)]
    rows = torch.tensor([[c < wo[o] for c in range(W)]
                         for o in range(NUM_OPS)], dtype=torch.float32)
    se_rows = torch.tensor([[c < so[o] for c in range(SE)]
                            for o in range(NUM_OPS)], dtype=torch.float32)
    taps = torch.zeros(NUM_OPS, KMAX, KMAX)
    for o in range(NUM_OPS):
        off = (KMAX - OP_KERNEL[o]) // 2
        taps[o, off:KMAX - off, off:KMAX - off] = 1.0
    has_se = torch.tensor([float(s > 0) for s in so])
    return {
        ("expand", "kernel"): ((NUM_OPS, W, ic, 1, 1), [ic] * NUM_OPS,
                               rows[:, :, None, None, None]),
        ("depth", "kernel"): ((NUM_OPS, W, 1, KMAX, KMAX),
                              [OP_KERNEL[o] ** 2 for o in range(NUM_OPS)],
                              rows[:, :, None, None, None]
                              * taps[:, None, None]),
        ("se", "reduce_kernel"): ((NUM_OPS, W, SE), wo,
                                  rows[:, :, None] * se_rows[:, None, :]),
        ("se", "reduce_bias"): ((NUM_OPS, SE), wo, se_rows),
        ("se", "expand_kernel"): ((NUM_OPS, SE, W), so,
                                  se_rows[:, :, None] * rows[:, None, :]),
        ("se", "expand_bias"): ((NUM_OPS, W), so,
                                rows * has_se[:, None]),
        ("project", "kernel"): ((NUM_OPS, oc, W, 1, 1), wo,
                                rows[:, None, :, None, None]),
    }


class SuperNet:
    """The supernet of a Space with `num_classes` outputs."""

    def __init__(self, space, num_classes):
        self.space = space
        self.num_classes = num_classes
        self.first_stem = ConvLayer(affine=False, **space.stem)
        self.second_stem = MBInvertedResBlock(affine=False,
                                              **space.second_stem)
        self.feature_mix = ConvLayer(affine=False, **space.head)
        self.classifier = LinearLayer(space.head_features, num_classes)

    # -- weights ----------------------------------------------------------

    def make_params(self, pool):
        """(params, arch_params) on the Pool's device: every stacked leaf
        is U(-b, b) with b = 1/sqrt(fan-in of its candidate), zero where
        the candidate has no entry."""
        dev = pool.device
        generator = pool
        params = {"first_stem": self.first_stem.init(generator)[0],
                  "second_stem": self.second_stem.init(generator)[0]}
        for site in self.space.sites:
            layout = _block_layout(site)
            sizes = [math.prod(shape) for shape, _, _ in layout.values()]
            u = pool.rand((sum(sizes),))
            block, off = {}, 0
            for (group, name), (shape, fans, mask), n in zip(
                    layout.keys(), layout.values(), sizes):
                bound = torch.tensor([1.0 / math.sqrt(f) if f else 0.0
                                      for f in fans], device=dev)
                bound = bound.reshape((-1,) + (1,) * (len(shape) - 1))
                leaf = (u[off:off + n].reshape(shape) * 2.0 - 1.0) * bound
                block.setdefault(group, {})[name] = leaf * mask.to(dev)
                off += n
            params.setdefault(site.stage, {})[site.block] = block
        params["feature_mix_layer"] = self.feature_mix.init(generator)[0]
        params["classifier"] = self.classifier.init(generator)[0]
        arch = {
            "log_alphas": torch.full((len(self.space.sites), NUM_OPS),
                                     -math.log(NUM_OPS), device=dev),
            "betas": {st: torch.zeros(self.space.depth(st), device=dev)
                      for st in self.space.stages},
        }
        return params, arch

    def masks(self, mc_mask_dddict, device):
        """{stage: {block: [8, W] width masks}}, zero-padded to W."""
        out = {}
        for s in self.space.sites:
            m = torch.zeros(NUM_OPS, s.width)
            for o in range(NUM_OPS):
                v = torch.from_numpy(np.asarray(
                    mc_mask_dddict[s.stage][s.block][o], np.float32))
                m[o, :v.shape[0]] = v
            out.setdefault(s.stage, {})[s.block] = m.to(device)
        return out

    def update_masks(self, params, masks):
        """Leaves multiplying the weight update: 0 at masked-out and padded
        entries of the stacked block leaves, so they stay frozen; None
        outside the blocks."""
        out = {}
        for name, sub in params.items():
            if not name.startswith("stage"):
                out[name] = _none_tree(sub)
        for s in self.space.sites:
            cm = masks[s.stage][s.block]
            dev = cm.device
            taps = torch.zeros(NUM_OPS, KMAX, KMAX, device=dev)
            sm = torch.zeros(NUM_OPS, s.se_width, device=dev)
            for o in range(NUM_OPS):
                off = (KMAX - OP_KERNEL[o]) // 2
                taps[o, off:KMAX - off, off:KMAX - off] = 1.0
                sm[o, :s.ic * OP_SE_MULT[o]] = 1.0
            out.setdefault(s.stage, {})[s.block] = {
                "expand": {"kernel": cm[:, :, None, None, None]},
                "depth": {"kernel": (cm[:, :, None, None, None]
                                     * taps[:, None, None, :, :])},
                "se": {"reduce_kernel": cm[:, :, None] * sm[:, None, :],
                       "reduce_bias": sm,
                       "expand_kernel": sm[:, :, None] * cm[:, None, :],
                       "expand_bias": cm},
                "project": {"kernel": cm[:, None, :, None, None]},
            }
        return out

    # -- pieces ------------------------------------------------------------

    def _stem(self, params, x):
        x, _ = self.first_stem.apply(params["first_stem"], {}, x,
                                     training=True)
        x, _ = self.second_stem.apply(params["second_stem"], {}, x,
                                      training=True)
        return x

    def _head(self, params, x):
        x, _ = self.feature_mix.apply(params["feature_mix_layer"], {}, x,
                                      training=True)
        x, _ = self.classifier.apply(params["classifier"], {},
                                     x.mean(dim=(2, 3)))
        return x

    @staticmethod
    def _masked_bn_act(h, mask, act):
        """act(mask * BN(h)) with batch moments, per channel."""
        mean = h.mean(dim=(0, 2, 3))
        var = (h * h).mean(dim=(0, 2, 3)) - mean * mean
        inv = torch.rsqrt(var + 1e-5) * mask
        return apply_act(h * inv[None, :, None, None]
                         - (mean * inv)[None, :, None, None], act)

    def _dw_middle(self, h, dwk, mask, act, stride):
        """mask -> BN -> act -> 5x5 depthwise -> mask -> BN -> act."""
        x1 = self._masked_bn_act(h, mask, act)
        h2 = F.conv2d(rnd(x1), rnd(dwk), None, stride, KMAX // 2, 1,
                      dwk.shape[0])
        return self._masked_bn_act(h2, mask, act)

    @staticmethod
    def _se(h, rk, rb, xk, xb, has_se, act):
        z = apply_act(rnd(h.mean(dim=(2, 3))) @ rnd(rk) + rb, act)
        g = torch.sigmoid(rnd(z) @ rnd(xk) + xb)
        return h * (g if has_se else torch.ones_like(g))[:, :, None, None]

    def _block_sampled(self, site, p, pad_mask, op, x):
        mask = pad_mask[op]
        h = conv2d(x, p["expand"]["kernel"][op])
        h = self._dw_middle(h, p["depth"]["kernel"][op], mask, site.act,
                            site.stride)
        se = p["se"]
        h = self._se(h, se["reduce_kernel"][op], se["reduce_bias"][op],
                     se["expand_kernel"][op], se["expand_bias"][op],
                     OP_SE_MULT[op] > 0, site.act)
        y = conv2d(h, p["project"]["kernel"][op])
        y, _ = batch_norm(y, {}, {}, affine=False, training=True)
        return y + x if site.has_residual else y

    def _block_soft(self, site, p, pad_mask, w, x):
        """sum_o w_o * op_o(x): each candidate at its stacked width."""
        W, ys = site.width, []
        for o in range(NUM_OPS):
            wd = W if OP_MAX_EXPAND[o] == 8 else W // 2
            mask = pad_mask[o, :wd]
            h = conv2d(x, p["expand"]["kernel"][o, :wd])
            h = self._dw_middle(h, p["depth"]["kernel"][o, :wd], mask,
                                site.act, site.stride)
            se = p["se"]
            h = self._se(h, se["reduce_kernel"][o, :wd],
                         se["reduce_bias"][o], se["expand_kernel"][o, :, :wd],
                         se["expand_bias"][o, :wd], OP_SE_MULT[o] > 0,
                         site.act)
            ys.append(conv2d(h, p["project"]["kernel"][o, :, :wd]))
        y, _ = batch_norm(torch.cat(ys, dim=1), {}, {}, affine=False,
                          training=True)
        n, _, hh, ww = y.shape
        y = torch.einsum("nochw,o->nchw",
                         y.reshape(n, NUM_OPS, site.oc, hh, ww), w)
        return y + x if site.has_residual else y

    def _trunk(self, params, arch, x, block_fn):
        si = 0
        for stage in self.space.stages:
            depth = self.space.depth(stage)
            outs, h = [], x
            for d in range(depth):
                site = self.space.sites[si + d]
                h = block_fn(site, params[site.stage][site.block], h)
                outs.append(h)
            w = torch.softmax(arch["betas"][stage], dim=0)
            x = sum(w[d] * r for d, r in enumerate(outs))
            si += depth
        return x

    # -- forwards ----------------------------------------------------------

    def apply_sampled_pair(self, params, arch, masks, x, idx_a, idx_b):
        """(logits_a, logits_b) of two hard-sampled paths over one stem."""
        s = self._stem(params, x.permute(0, 3, 1, 2))
        out = []
        for idx in (idx_a, idx_b):
            ops = [int(i) for i in idx.tolist()]

            def block(site, p, h):
                return self._block_sampled(
                    site, p, masks[site.stage][site.block],
                    ops[site.global_idx], h)
            out.append(self._head(params, self._trunk(params, arch, s,
                                                      block)))
        return tuple(out)

    def apply_soft(self, params, arch, masks, x, weights, lat_vec):
        """(logits, latency without 'base') of the soft forward."""
        x = self._stem(params, x.permute(0, 3, 1, 2))
        total = torch.zeros((), device=x.device, dtype=x.dtype)
        si = 0
        for stage in self.space.stages:
            depth = self.space.depth(stage)
            outs, lats, h = [], [], x
            cum = torch.zeros((), device=x.device, dtype=x.dtype)
            for d in range(depth):
                site = self.space.sites[si + d]
                wv = weights[site.global_idx]
                h = self._block_soft(site, params[site.stage][site.block],
                                     masks[site.stage][site.block], wv, h)
                cum = cum + torch.dot(wv, lat_vec[site.global_idx])
                outs.append(h)
                lats.append(cum)
            w = torch.softmax(arch["betas"][stage], dim=0)
            x = sum(w[d] * r for d, r in enumerate(outs))
            total = total + sum(w[d] * l for d, l in enumerate(lats))
            si += depth
        return self._head(params, x), total


def _none_tree(tree):
    if isinstance(tree, dict):
        return {k: _none_tree(v) for k, v in tree.items()}
    return None
