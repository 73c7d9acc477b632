"""The TF-NAS supernet with stacked MixedOps
(counterpart of tfnas_tpu/models/supernet.py).

Every block stores its 8 candidates stacked along a leading op axis at one
canonical shape: k3 depthwise taps zero-padded to 5x5, e3 widths padded to
the e6 width W = 8 * ic, SE weights zero for candidates without SE. Width
elasticity is channel masks over these fixed shapes; masked channels give
exactly zero activations, and `update_masks` keeps their updates exactly
zero.

Parameter layout (`convert.py` maps it from and to the JAX trees):
expand [8, W, ic, 1, 1], depth [8, W, 1, 5, 5], project [8, oc, W, 1, 1]
(stacked OIHW); SE kernels keep the JAX [8, W, SE] / [8, SE, W].

Public forwards take x as [N, H, W, C]; inside, activations are logical NCHW
(channels_last in memory when x is contiguous NHWC). The depthwise middle of
every block runs through `fused_dw_norm_act`, which launches the
hand-written CUDA kernel for tensors on the card.

bn_group: the process group of cross-replica BN when the search itself
runs data-parallel (the ranks of one Pareto group). Every BN then takes its
statistics over the group's global batch: the depthwise middle sums its two
pairs of per-channel sums over the ranks, the kernel's own output sums
included, and the other BNs go through ops/batchnorm.py with the group.

The JAX package's opt-in lowerings, with its defaults (each computes the
same function as the default path):
- remat_blocks: every block forward runs under activation checkpointing
  and is recomputed in the backward;
- cond_width_split: a sampled e3 candidate runs at its true width W / 2.
  The op index is read on the host per block, so such a net runs eagerly
  only: make_search_steps(family=...) refuses it;
- project_einsum=False: the soft path's per-candidate 1x1 project as
  grouped convolutions instead of one batched product;
- dw_kernel_split: the soft path's depthwise as true 3x3 and 5x5
  convolutions over the channel layout [k3e3 | k3e6 | k5e3 | k5e6]. These
  are cuDNN's, as they are XLA's in the JAX package: no fused kernel runs
  in the soft blocks then.
`apply_multi_sampled` runs S sampled sub-networks as S channel groups of
one pass (the fused kernel over S * W channels); no step uses it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_dw import fold_bn_mask, fused_dw_norm_act
from ..ops.activations import apply_act
from ..ops.batchnorm import BN_EPS, batch_norm, stat_dtype
from ..ops.conv import init_conv_kernel, torch_uniform_init
from ..ops.layers import ConvLayer, LinearLayer, MBInvertedResBlock
from ..parallel.mesh import all_reduce_sum, group_size
from . import search_space as ss

KMAX = 5  # canonical depthwise tap size (k3 kernels zero-padded)


@dataclasses.dataclass(frozen=True)
class BlockSite:
    """One searchable block position in the macro skeleton."""
    stage: str
    block: str
    global_idx: int
    ic: int
    oc: int
    stride: int
    act: str

    @property
    def width(self):
        """Canonical stacked branch width W = 8 * ic (max e6 width)."""
        return self.ic * max(ss.OP_MAX_EXPAND)

    @property
    def se_width(self):
        return self.ic * max(ss.OP_SE_MULT)

    @property
    def has_residual(self):
        return self.ic == self.oc and self.stride == 1


def block_sites(space=None):
    sp = space or ss
    sites, g = [], 0
    for stage, spec in sp.STAGE_SPECS.items():
        for i in range(len(spec["ics"])):
            sites.append(BlockSite(stage, f"block{i + 1}", g, spec["ics"][i],
                                   spec["ocs"][i], spec["ss"][i],
                                   spec["acts"][i]))
            g += 1
    return sites


def _pad_dim(t, dim, size):
    """Zero-pad dim `dim` of t at its end up to `size`."""
    pad = [0, 0] * t.dim()
    pad[2 * (t.dim() - 1 - dim) + 1] = size - t.shape[dim]
    return F.pad(t, pad)


def _dw_tap_mask(op_idx):
    """[KMAX, KMAX] mask of live taps for this op's kernel size."""
    k = ss.OP_KERNEL[op_idx]
    m = np.zeros((KMAX, KMAX), np.float32)
    off = (KMAX - k) // 2
    m[off:off + k, off:off + k] = 1.0
    return m


def _take(t, idx):
    """t[idx] along dim 0 for a 0-dim integer tensor, without a host sync."""
    return t.index_select(0, idx.reshape(1)).squeeze(0)


class SuperNetwork:
    """Supernet over the TF-NAS space (or a make_space namespace)."""

    def __init__(self, num_classes, space=None, bn_group=None,
                 remat_blocks=False, cond_width_split=False,
                 project_einsum=True, dw_kernel_split=False):
        self.ss = space or ss
        self.num_classes = num_classes
        self.bn_group = bn_group
        self.remat_blocks = bool(remat_blocks)
        self.cond_width_split = bool(cond_width_split)
        self.project_einsum = bool(project_einsum)
        self.dw_kernel_split = bool(dw_kernel_split)
        self.first_stem = ConvLayer(affine=False, **self.ss.STEM_CONV)
        self.second_stem = MBInvertedResBlock(affine=False,
                                              **self.ss.SECOND_STEM)
        self.sites = block_sites(self.ss)
        self.feature_mix_layer = ConvLayer(affine=False, **self.ss.HEAD_CONV)
        self.classifier = LinearLayer(self.ss.HEAD_FEATURES, num_classes)
        self._se_on = {}  # device -> bool [8] tensor

    # -- init --------------------------------------------------------------

    def _init_block(self, site, generator):
        """Init the 8 candidates at their true shapes (torch fan-ins), then
        pad and stack them to the canonical shape."""
        W, SE = site.width, site.se_width
        ic, oc = site.ic, site.oc
        expand, depth, red_k, red_b, exp_k, exp_b, proj = \
            [], [], [], [], [], [], []
        for o in range(ss.NUM_OPS):
            k = ss.OP_KERNEL[o]
            w_o = ic * ss.OP_MAX_EXPAND[o]
            se_o = ic * ss.OP_SE_MULT[o]
            expand.append(_pad_dim(init_conv_kernel(1, 1, ic, w_o, generator),
                                   0, W))
            off = (KMAX - k) // 2
            dk = F.pad(init_conv_kernel(k, k, 1, w_o, generator),
                       (off, off, off, off))
            depth.append(_pad_dim(dk, 0, W))
            if se_o > 0:
                red_k.append(_pad_dim(_pad_dim(torch_uniform_init(
                    (w_o, se_o), w_o, generator), 0, W), 1, SE))
                red_b.append(_pad_dim(torch_uniform_init(
                    (se_o,), w_o, generator), 0, SE))
                exp_k.append(_pad_dim(_pad_dim(torch_uniform_init(
                    (se_o, w_o), se_o, generator), 0, SE), 1, W))
                exp_b.append(_pad_dim(torch_uniform_init(
                    (w_o,), se_o, generator), 0, W))
            else:
                z = dict(device=generator.device)
                red_k.append(torch.zeros((W, SE), **z))
                red_b.append(torch.zeros((SE,), **z))
                exp_k.append(torch.zeros((SE, W), **z))
                exp_b.append(torch.zeros((W,), **z))
            proj.append(_pad_dim(init_conv_kernel(1, 1, w_o, oc, generator),
                                 1, W))
        return {
            "expand": {"kernel": torch.stack(expand)},    # [8,W,ic,1,1]
            "depth": {"kernel": torch.stack(depth)},      # [8,W,1,5,5]
            "se": {
                "reduce_kernel": torch.stack(red_k),      # [8,W,SE]
                "reduce_bias": torch.stack(red_b),        # [8,SE]
                "expand_kernel": torch.stack(exp_k),      # [8,SE,W]
                "expand_bias": torch.stack(exp_b),        # [8,W]
            },
            "project": {"kernel": torch.stack(proj)},     # [8,oc,W,1,1]
        }

    def init(self, generator):
        """(params, arch_params) on the generator's device."""
        params = {"first_stem": self.first_stem.init(generator)[0],
                  "second_stem": self.second_stem.init(generator)[0]}
        for site in self.sites:
            params.setdefault(site.stage, {})[site.block] = \
                self._init_block(site, generator)
        params["feature_mix_layer"] = self.feature_mix_layer.init(generator)[0]
        params["classifier"] = self.classifier.init(generator)[0]
        dev = generator.device
        arch_params = {
            "log_alphas": torch.full((len(self.sites), ss.NUM_OPS),
                                     -math.log(ss.NUM_OPS), device=dev),
            "betas": {stage: torch.zeros(self.ss.STAGE_DEPTHS[stage],
                                         device=dev)
                      for stage in self.ss.STAGE_NAMES},
        }
        return params, arch_params

    # -- shared pieces -----------------------------------------------------

    def _stem(self, params, x, training):
        x, _ = self.first_stem.apply(params["first_stem"], {}, x,
                                     training=training,
                                     bn_group=self.bn_group)
        x, _ = self.second_stem.apply(params["second_stem"], {}, x,
                                      training=training,
                                      bn_group=self.bn_group)
        return x

    def _head(self, params, x, training):
        x, _ = self.feature_mix_layer.apply(params["feature_mix_layer"], {},
                                            x, training=training,
                                            bn_group=self.bn_group)
        x = x.mean(dim=(2, 3))
        x, _ = self.classifier.apply(params["classifier"], {}, x,
                                     training=training,
                                     bn_group=self.bn_group)
        return x

    @staticmethod
    def _conv(x, kernel, stride=1, groups=1):
        return F.conv2d(x, kernel.to(x.dtype), None, stride,
                        kernel.shape[-1] // 2, 1, groups)

    def _se_on_tensor(self, device):
        if device not in self._se_on:
            self._se_on[device] = torch.tensor(
                [m > 0 for m in ss.OP_SE_MULT], device=device)
        return self._se_on[device]

    def _group_sums(self, s, q, n):
        """(s, q, n) summed over the ranks of bn_group: one differentiable
        all-reduce of a [2C] buffer; unchanged without a group."""
        if self.bn_group is None:
            return s, q, n
        s, q = all_reduce_sum(torch.cat([s, q]), self.bn_group).chunk(2)
        return s, q, n * group_size(self.bn_group)

    def _masked_sums(self, h, mask):
        """Per-channel (sum, sum of squares, count) of mask * h in the
        statistics dtype."""
        sd = stat_dtype(h.dtype)
        hm = h.to(sd) * mask.to(sd)[None, :, None, None]
        return (hm.sum(dim=(0, 2, 3)), (hm * hm).sum(dim=(0, 2, 3)),
                h.shape[0] * h.shape[2] * h.shape[3])

    def _fold_sums(self, s, q, n, mask):
        """(scale, offset) of the masked batch-stat BN whose per-channel
        sums over n values are s and q; with a bn_group, the group's."""
        s, q, n = self._group_sums(s, q, n)
        mean = s / n
        var = q / n - mean * mean
        return fold_bn_mask(mean, var, mask, BN_EPS)

    @staticmethod
    def _norm_act(h, scale, offset, act):
        sd = stat_dtype(h.dtype)
        return apply_act((h.to(sd) * scale[None, :, None, None]
                          + offset[None, :, None, None]).to(h.dtype), act)

    def _dw_middle(self, h_raw, dwk, mask, act, stride):
        """mask -> BN -> act -> depthwise -> BN -> act over the raw expand
        output h_raw [N, C, H, W]; dwk: [C, 1, 5, 5]; mask: [C].

        The first BN's statistics are taken here; normalise + act, the 5x5
        depthwise and the second BN's statistics are one fused_dw_norm_act
        call. Search BN is batch-stat-only and affine-free. With a
        bn_group, both pairs of sums are the group's (the kernel's backward
        then receives their cotangents summed over the ranks)."""
        scale1, offset1 = self._fold_sums(*self._masked_sums(h_raw, mask),
                                          mask)
        x_nhwc = h_raw.permute(0, 2, 3, 1).contiguous()
        h2, s2, q2 = fused_dw_norm_act(x_nhwc, dwk[:, 0].permute(1, 2, 0),
                                       scale1, offset1, stride, act)
        scale2, offset2 = self._fold_sums(
            s2, q2, h2.shape[0] * h2.shape[1] * h2.shape[2], mask)
        return self._norm_act(h2.permute(0, 3, 1, 2), scale2, offset2, act)

    def _dw_middle_parts(self, h_raw, parts, mask, act, stride):
        """_dw_middle with the depthwise run as one convolution per
        channel-contiguous part at its true tap size: parts [(dwk [C_part,
        1, k, k], k)] cover the channels in order. A zero tap ring adds
        nothing, so this is the function of one conv over padded taps. No
        fused kernel runs here (the JAX package's XLA convolutions)."""
        scale1, offset1 = self._fold_sums(*self._masked_sums(h_raw, mask),
                                          mask)
        x1 = self._norm_act(h_raw, scale1, offset1, act)
        outs, c0 = [], 0
        for dwk, k in parts:
            c1 = c0 + dwk.shape[0]
            outs.append(F.conv2d(x1[:, c0:c1], dwk.to(x1.dtype), None,
                                 stride, k // 2, 1, c1 - c0))
            c0 = c1
        h2 = torch.cat(outs, dim=1)
        scale2, offset2 = self._fold_sums(*self._masked_sums(h2, mask), mask)
        return self._norm_act(h2, scale2, offset2, act)

    # -- soft (all-branches) block ----------------------------------------

    @staticmethod
    def _se_gate_seg(pooled, rk, rb, xk, xb, on, act, out_dtype):
        """SE gates [N, G, W_seg] of G candidates from their pooled
        features [N, G, W_seg]; 1 for the candidates without SE."""
        z = torch.einsum("now,ows->nos", pooled, rk.to(pooled.dtype))
        z = apply_act(z + rb.to(pooled.dtype), act)
        g = torch.einsum("nos,osw->now", z, xk.to(pooled.dtype))
        g = g + xb.to(pooled.dtype)
        return torch.where(on[None, :, None],
                           torch.sigmoid(g.to(stat_dtype(g.dtype))),
                           1.0).to(out_dtype)

    def _soft_segments(self, W):
        """(first op, op stride, width, true tap size) of each channel
        segment of the soft block: the ops start::step run at `width`.

        Default: [e3 ops (0, 2, 4, 6) x W/2 | e6 ops (1, 3, 5, 7) x W], one
        5x5 depthwise over all. dw_kernel_split: [k3e3 (0, 4) | k3e6 (1, 5)
        | k5e3 (2, 6) | k5e6 (3, 7)], the k3 half at its true 3x3 taps."""
        we3 = W // 2
        if self.dw_kernel_split:
            return ((0, 4, we3, 3), (1, 4, W, 3), (2, 4, we3, KMAX),
                    (3, 4, W, KMAX))
        return ((0, 2, we3, KMAX), (1, 2, W, KMAX))

    def _block_soft(self, site, p, pad_mask, w, x, training):
        """All 8 branches fused; returns sum_o w_o * op_o(x) (the JAX
        package's _block_soft and, with dw_kernel_split, its
        _block_soft_ksplit).

        pad_mask: [8, W] width masks; w: [8] Gumbel weights. The e3
        candidates run at their true width W/2; each segment of
        `_soft_segments` is a contiguous channel range downstream."""
        n_ops, W = pad_mask.shape
        segs = self._soft_segments(W)
        sl = [slice(a, None, b) for a, b, _, _ in segs]
        flat_mask = torch.cat([pad_mask[s, :wd].reshape(-1)
                               for s, (_, _, wd, _) in zip(sl, segs)])

        ek = p["expand"]["kernel"]                        # [8,W,ic,1,1]
        h = self._conv(x, torch.cat([
            ek[s, :wd].reshape(-1, site.ic, 1, 1)
            for s, (_, _, wd, _) in zip(sl, segs)]))

        dk = p["depth"]["kernel"]                         # [8,W,1,5,5]
        if not self.dw_kernel_split:
            h = self._dw_middle(h, torch.cat([
                dk[s, :wd].reshape(-1, 1, KMAX, KMAX)
                for s, (_, _, wd, _) in zip(sl, segs)]), flat_mask,
                site.act, site.stride)
        else:
            parts = []  # adjacent segments with equal taps share a conv
            for s, (_, _, wd, k) in zip(sl, segs):
                off = (KMAX - k) // 2
                dwk = dk[s, :wd, :, off:KMAX - off, off:KMAX - off]
                dwk = dwk.reshape(-1, 1, k, k)
                if parts and parts[-1][1] == k:
                    parts[-1] = (torch.cat([parts[-1][0], dwk]), k)
                else:
                    parts.append((dwk, k))
            h = self._dw_middle_parts(h, parts, flat_mask, site.act,
                                      site.stride)

        se, se_on = p["se"], self._se_on_tensor(h.device)
        nb, hh, ww = h.shape[0], h.shape[2], h.shape[3]
        pk = p["project"]["kernel"]                       # [8,oc,W,1,1]
        ys, c0 = [], 0
        for s, (_, _, wd, _) in zip(sl, segs):
            g = len(range(n_ops)[s])
            c1 = c0 + g * wd
            hs = h[:, c0:c1]
            gate = self._se_gate_seg(
                hs.mean(dim=(2, 3)).reshape(nb, g, wd),
                se["reduce_kernel"][s, :wd], se["reduce_bias"][s],
                se["expand_kernel"][s, :, :wd], se["expand_bias"][s, :wd],
                se_on[s], site.act, hs.dtype)
            hs = hs * gate.reshape(nb, g * wd, 1, 1)
            # per-branch 1x1 project: one batched product over the op axis,
            # or a grouped convolution; either gives [N, h, w, G, oc]
            if self.project_einsum:
                ys.append(torch.einsum(
                    "nhwgc,goc->nhwgo",
                    hs.permute(0, 2, 3, 1).reshape(nb, hh, ww, g, wd),
                    pk[s, :, :wd, 0, 0].to(h.dtype)))
            else:
                ys.append(self._conv(
                    hs, pk[s, :, :wd].reshape(g * site.oc, wd, 1, 1),
                    groups=g).permute(0, 2, 3, 1).reshape(
                        nb, hh, ww, g, site.oc))
            c0 = c1
        y = torch.cat(ys, dim=3).reshape(nb, hh, ww, n_ops * site.oc)
        y, _ = batch_norm(y.permute(0, 3, 1, 2), {}, {}, affine=False,
                          training=training, group=self.bn_group)

        # weighted cross-branch sum after the per-branch project BN
        w_perm = torch.cat([w[s] for s in sl])
        y = torch.einsum("nochw,o->nchw",
                         y.reshape(nb, n_ops, site.oc, hh, ww),
                         w_perm.to(y.dtype))
        if site.has_residual:
            y = y + x  # sum_o w_o (out_o + res) == sum_o w_o out_o + res
        return y

    # -- hard (sampled) block ---------------------------------------------

    def _block_sampled(self, site, p, pad_mask, op_idx, x, training):
        """One branch, its weights gathered from the stacked arrays by the
        0-dim integer tensor op_idx.

        cond_width_split runs an e3 pick (even op index) at W/2 = 4 * ic,
        exact because its upper half is mask-zero padding. It reads op_idx
        on the host, so it waits for the card once per block."""
        width = site.width
        if self.cond_width_split and int(op_idx) % 2 == 0:
            width //= 2
        mask = _take(pad_mask, op_idx)[:width]
        h = self._conv(x, _take(p["expand"]["kernel"], op_idx)[:width])
        h = self._dw_middle(h, _take(p["depth"]["kernel"], op_idx)[:width],
                            mask, site.act, site.stride)

        se = p["se"]
        pooled = h.mean(dim=(2, 3))                         # [N, W]
        rk = _take(se["reduce_kernel"], op_idx)[:width]
        rb = _take(se["reduce_bias"], op_idx)
        xk = _take(se["expand_kernel"], op_idx)[:, :width]
        xb = _take(se["expand_bias"], op_idx)[:width]
        z = apply_act(pooled @ rk.to(h.dtype) + rb.to(h.dtype), site.act)
        g = z @ xk.to(h.dtype) + xb.to(h.dtype)
        has_se = _take(self._se_on_tensor(h.device), op_idx)
        gate = torch.where(has_se, torch.sigmoid(g.to(stat_dtype(g.dtype))),
                           1.0)
        h = h * gate[:, :, None, None].to(h.dtype)

        y = self._conv(h, _take(p["project"]["kernel"], op_idx)[:, :width])
        y, _ = batch_norm(y, {}, {}, affine=False, training=training,
                          group=self.bn_group)
        if site.has_residual:
            y = y + x
        return y

    # -- multi-sample (grouped) block -------------------------------------

    def _block_multi(self, site, p, pad_mask, op_idx_s, x, training):
        """S sampled candidates as S disjoint channel groups of one pass.

        op_idx_s: integer [S]; x: [N, S * ic, H, W], group s carrying sample
        set s. Returns [N, S * oc, H', W']. The function of S _block_sampled
        calls (grouped convolutions and per-channel BN keep the groups
        apart); the depthwise middle runs over S * W channels."""
        S, W = op_idx_s.shape[0], site.width
        mask = pad_mask.index_select(0, op_idx_s).reshape(-1)
        h = self._conv(x, p["expand"]["kernel"].index_select(0, op_idx_s)
                       .reshape(S * W, site.ic, 1, 1), groups=S)
        h = self._dw_middle(h, p["depth"]["kernel"].index_select(
            0, op_idx_s).reshape(S * W, 1, KMAX, KMAX), mask, site.act,
            site.stride)

        se = p["se"]
        pooled = h.mean(dim=(2, 3)).reshape(-1, S, W)       # [N, S, W]
        rk = se["reduce_kernel"].index_select(0, op_idx_s)  # [S, W, SE]
        rb = se["reduce_bias"].index_select(0, op_idx_s)
        xk = se["expand_kernel"].index_select(0, op_idx_s)
        xb = se["expand_bias"].index_select(0, op_idx_s)
        z = torch.einsum("nsw,swe->nse", pooled, rk.to(h.dtype))
        z = apply_act(z + rb.to(h.dtype), site.act)
        g = torch.einsum("nse,sew->nsw", z, xk.to(h.dtype)) + xb.to(h.dtype)
        has_se = self._se_on_tensor(h.device).index_select(0, op_idx_s)
        gate = torch.where(has_se[None, :, None],
                           torch.sigmoid(g.to(stat_dtype(g.dtype))), 1.0)
        h = h * gate.reshape(h.shape[0], S * W, 1, 1).to(h.dtype)

        y = self._conv(h, p["project"]["kernel"].index_select(0, op_idx_s)
                       .reshape(S * site.oc, W, 1, 1), groups=S)
        y, _ = batch_norm(y, {}, {}, affine=False, training=training,
                          group=self.bn_group)
        if site.has_residual:
            y = y + x
        return y

    # -- block dispatch (hooks for the hybrid subclass) -------------------

    def _maybe_remat(self, fn):
        """fn under activation checkpointing with remat_blocks: its
        activations are dropped and the backward recomputes its forward.
        No block draws random numbers, so no RNG state is stashed (a CUDA
        graph capture could not stash it)."""
        if not self.remat_blocks:
            return fn
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)

    def _block_masks(self, masks, site):
        """The block's slice of the device-mask tree."""
        return masks[site.stage][site.block]

    def _sampled_block_fn(self, site, training):
        """fn(p, masks, op_idx, x): the block's hard-sampled forward."""
        def fn(p, masks, op_idx, x):
            return self._block_sampled(site, p, self._block_masks(masks, site),
                                       op_idx, x, training)
        return self._maybe_remat(fn)

    def _soft_block_fn(self, site, training):
        """fn(p, masks, w, x): the block's all-candidates soft forward."""
        def fn(p, masks, w, x):
            return self._block_soft(site, p, self._block_masks(masks, site),
                                    w, x, training)
        return self._maybe_remat(fn)

    # -- public forwards ---------------------------------------------------

    def _trunk(self, params, arch_params, x, block_fn):
        """Stages of blocks with softmax(betas) sink mixing; block_fn(site,
        p, h) runs one block. Returns the last stage's mixed output."""
        si = 0
        for stage in self.ss.STAGE_NAMES:
            depth = self.ss.STAGE_DEPTHS[stage]
            res_list, h = [], x
            for d in range(depth):
                site = self.sites[si + d]
                h = block_fn(site, params[site.stage][site.block], h)
                res_list.append(h)
            w = torch.softmax(arch_params["betas"][stage], dim=0)
            x = sum(w[d].to(r.dtype) * r for d, r in enumerate(res_list))
            si += depth
        return x

    def apply_sampled(self, params, arch_params, masks, x, op_indices, *,
                      training=True):
        """Hard-sampled forward. x: [N, H, W, C]; op_indices: integer [18]
        tensor. Returns logits."""
        h = self._stem(params, x.permute(0, 3, 1, 2), training)
        return self._head(params, self._sampled_trunk(
            params, arch_params, masks, h, op_indices, training), training)

    def _sampled_trunk(self, params, arch_params, masks, h, op_indices,
                       training):
        def block(site, p, h):
            return self._sampled_block_fn(site, training)(
                p, masks, op_indices[site.global_idx], h)
        return self._trunk(params, arch_params, h, block)

    def apply_sampled_pair(self, params, arch_params, masks, x, idx_a,
                           idx_b, *, training=True):
        """The bi-sampling pair of hard forwards with the stem computed
        once (both trunks see the same batch through the same stem, so
        sharing it is exact). Returns (logits_a, logits_b)."""
        s = self._stem(params, x.permute(0, 3, 1, 2), training)
        return tuple(
            self._head(params, self._sampled_trunk(
                params, arch_params, masks, s, idx, training), training)
            for idx in (idx_a, idx_b))

    def apply_multi_sampled(self, params, arch_params, masks, x, op_indices,
                            *, training=True):
        """S hard-sampled forwards as S channel groups of one pass.

        op_indices: integer [S, 18]. The stem runs once and its output is
        tiled S times along the channels; the head is a grouped convolution
        over the tiled feature_mix_layer kernel. Returns logits [S, N,
        num_classes], the function of S apply_sampled calls."""
        S = op_indices.shape[0]
        h = self._stem(params, x.permute(0, 3, 1, 2), training).repeat(
            1, S, 1, 1)

        def block(site, p, h):
            return self._maybe_remat(functools.partial(
                self._block_multi, site, training=training))(
                p, self._block_masks(masks, site),
                op_indices[:, site.global_idx], h)
        h = self._trunk(params, arch_params, h, block)

        fml = self.feature_mix_layer
        h = self._conv(h, params["feature_mix_layer"]["conv"]["kernel"]
                       .repeat(S, 1, 1, 1), groups=S)
        h, _ = batch_norm(h, {}, {}, affine=False, training=training,
                          group=self.bn_group)
        pooled = apply_act(h, fml.act_func).mean(dim=(2, 3)).reshape(
            -1, S, self.ss.HEAD_FEATURES)
        lin = params["classifier"]["linear"]
        logits = torch.einsum("nsf,fc->nsc", pooled,
                              lin["kernel"].to(pooled.dtype))
        return (logits + lin["bias"].to(logits.dtype)).transpose(0, 1)

    def apply_soft(self, params, arch_params, masks, x, gumbel_weights,
                   lat_vec, *, training=True):
        """Soft forward: all 8 fused branches weighted by gumbel_weights
        [18, 8], plus the differentiable latency (excluding 'base') from
        lat_vec [18, 8]. Returns (logits, latency)."""
        x = self._stem(params, x.permute(0, 3, 1, 2), training)
        total_lat = torch.zeros((), device=x.device)
        si = 0
        for stage in self.ss.STAGE_NAMES:
            depth = self.ss.STAGE_DEPTHS[stage]
            res_list, lat_list = [], []
            h = x
            cum_lat = torch.zeros((), device=x.device)
            for d in range(depth):
                site = self.sites[si + d]
                wv = gumbel_weights[site.global_idx]
                h = self._soft_block_fn(site, training)(
                    params[site.stage][site.block], masks, wv, h)
                cum_lat = cum_lat + torch.dot(wv, lat_vec[site.global_idx])
                res_list.append(h)
                lat_list.append(cum_lat)
            w = torch.softmax(arch_params["betas"][stage], dim=0)
            x = sum(w[d].to(r.dtype) * r for d, r in enumerate(res_list))
            total_lat = total_lat + sum(w[d] * l
                                        for d, l in enumerate(lat_list))
            si += depth
        return self._head(params, x, training), total_lat

    # -- masks -------------------------------------------------------------

    def host_stacked_masks(self, mc_mask_dddict):
        """Stacked padded [8, W] numpy mask arrays per block."""
        out = {}
        for site in self.sites:
            stacked = np.zeros((ss.NUM_OPS, site.width), np.float32)
            for o in range(ss.NUM_OPS):
                m = np.asarray(mc_mask_dddict[site.stage][site.block][o],
                               np.float32)
                stacked[o, :m.shape[0]] = m
            out.setdefault(site.stage, {})[site.block] = stacked
        return out

    def device_masks(self, mc_mask_dddict, device):
        """Mask registry (true per-op widths) -> {stage: {block: [8, W]}}
        tensors on `device`, as the apply_* paths take them."""
        return {stage: {b: torch.from_numpy(m).to(device)
                        for b, m in blocks.items()}
                for stage, blocks in
                self.host_stacked_masks(mc_mask_dddict).items()}

    def update_masks(self, params, mc_mask_dddict):
        """Tree shaped like `params` whose leaves multiply the optimizer's
        update: 0 for masked-out and padded entries of the stacked block
        parameters, so they stay exactly frozen; None where every entry
        updates."""
        host = self.host_stacked_masks(mc_mask_dddict)
        taps = torch.from_numpy(np.stack(
            [_dw_tap_mask(o) for o in range(ss.NUM_OPS)]))
        out = {}
        for name, sub in params.items():
            if not name.startswith("stage"):
                out[name] = _none_tree(sub)
                continue
            out[name] = {}
            for block in sub:
                site = next(s for s in self.sites
                            if (s.stage, s.block) == (name, block))
                dev = sub[block]["depth"]["kernel"].device
                cm = torch.from_numpy(host[name][block])          # [8, W]
                se_mask = np.zeros((ss.NUM_OPS, site.se_width), np.float32)
                for o in range(ss.NUM_OPS):
                    se_mask[o, :site.ic * ss.OP_SE_MULT[o]] = 1.0
                sm = torch.from_numpy(se_mask)
                tree = {
                    "expand": {"kernel": cm[:, :, None, None, None]},
                    "depth": {"kernel": (cm[:, :, None, None, None]
                                         * taps[:, None, None, :, :])},
                    "se": {
                        "reduce_kernel": cm[:, :, None] * sm[:, None, :],
                        "reduce_bias": sm,
                        "expand_kernel": sm[:, :, None] * cm[:, None, :],
                        "expand_bias": cm,
                    },
                    "project": {"kernel": cm[:, None, :, None, None]},
                }
                out[name][block] = {k: {kk: v.to(dev) for kk, v in d.items()}
                                    for k, d in tree.items()}
        return out


def _none_tree(tree):
    if isinstance(tree, dict):
        return {k: _none_tree(v) for k, v in tree.items()}
    return None
