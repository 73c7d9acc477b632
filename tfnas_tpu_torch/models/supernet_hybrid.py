"""The hybrid conv/ViT supernet (counterpart of
tfnas_tpu/models/supernet_hybrid.py).

SuperNetwork with a 9th candidate, the pre-norm transformer block of
ops/attention.py, at every block site of stages 4-6
(hybrid_space.VIT_STAGES). The 8 conv candidates keep their stacked layout
and their fused depthwise kernel; the ViT candidate runs beside them:

- soft block: y = fused_mb_soft(w[:8]) + w[8] * vit(x) - w[8] * x at a
  residual site, exactly sum_{o=0..8} w_o op_o(x): the conv path adds the
  residual once with weight 1 while its weights sum to 1 - w[8], and
  vit(x) carries its own + x;
- sampled block: the conv branch at min(op_idx, 7) and the ViT branch are
  both computed and the output selected by torch.where, so op_idx is never
  read on the host and the step stays capturable in a CUDA graph.

Arch parameters: log_alphas [18, 9]. The slots a block does not offer (the
ViT slot outside stages 4-6) are handled by the validity mask
(hybrid_space.valid_op_mask and the `valid` arguments of search/bisample.py)
and pinned to a finite sentinel by the projection of the arch step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hybrid_space as hs
from . import search_space as ss
from .supernet import SuperNetwork, _none_tree


class HybridSuperNetwork(SuperNetwork):
    """SuperNetwork over the 9-op hybrid conv/ViT space."""

    def __init__(self, num_classes, **kw):
        # kw: SuperNetwork's bn_group and lowering flags. The ViT
        # candidates' LayerNorms need no group (ops/attention.py)
        super().__init__(num_classes, **kw)
        self.vit = hs.vit_sites()   # global_idx -> (stage, block, entry)
        # search-time ViT blocks: the widest MLP, LN without affine (as the
        # search BNs are affine-free)
        self.vit_blocks = {
            g: hs.make_vit_op(entry, entry[1] * hs.VIT_MAX_EXPAND,
                              affine=False)
            for g, (stage, block, entry) in self.vit.items()}

    def valid_mask(self, device):
        """The [18, 9] 0/1 validity mask on `device`."""
        return torch.from_numpy(hs.valid_op_mask()).to(device)

    # -- init ---------------------------------------------------------------

    def init(self, generator):
        params, arch_params = super().init(generator)
        for g, (stage, block, _) in self.vit.items():
            params[stage][block]["vit"] = self.vit_blocks[g].init(
                generator)[0]
        # uniform over each block's valid candidates
        valid = hs.valid_op_mask()
        la = np.where(valid > 0, -np.log(valid.sum(-1, keepdims=True)),
                      -30.0).astype(np.float32)
        arch_params["log_alphas"] = torch.from_numpy(la).to(
            generator.device)
        return params, arch_params

    # -- masks ---------------------------------------------------------------

    def device_masks(self, mc_mask_dddict, device):
        """{'mb': the stacked [8, W] tree, 'vit': {stage: {block: the MLP
        hidden mask [VIT_MAX_EXPAND * oc]}}} on `device`."""
        out = {"mb": super().device_masks(mc_mask_dddict, device), "vit": {}}
        for stage, block, _ in self.vit.values():
            out["vit"].setdefault(stage, {})[block] = torch.from_numpy(
                np.asarray(mc_mask_dddict[stage][block][hs.VIT_OP_IDX],
                           np.float32)).to(device)
        return out

    def update_masks(self, params, mc_mask_dddict):
        """The conv candidates' update masks, and for the ViT candidate the
        MLP hidden rows and columns (kernels are [in, out]): masked hidden
        units take exactly zero updates. The other ViT parameters update
        everywhere."""
        out = super().update_masks(params, mc_mask_dddict)
        for stage, block, _ in self.vit.values():
            vp = params[stage][block]["vit"]
            m = torch.from_numpy(np.asarray(
                mc_mask_dddict[stage][block][hs.VIT_OP_IDX],
                np.float32)).to(vp["mlp_in"]["kernel"].device)
            up = _none_tree(vp)
            up["mlp_in"] = {"kernel": m[None, :], "bias": m}
            up["mlp_out"]["kernel"] = m[:, None]
            out[stage][block]["vit"] = up
        return out

    def _block_masks(self, masks, site):
        return masks["mb"][site.stage][site.block]

    # -- block dispatch -------------------------------------------------------

    def _vit_fn(self, site, training):
        vb = self.vit_blocks[site.global_idx]

        def vit(p, masks, x):
            return vb.apply(p["vit"], {}, x, training=training,
                            channel_mask=masks["vit"][site.stage][site.block]
                            )[0]
        return vit

    def _sampled_block_fn(self, site, training):
        if site.global_idx not in self.vit:
            return super()._sampled_block_fn(site, training)
        vit = self._vit_fn(site, training)

        def fn(p, masks, op_idx, x):
            mb = self._block_sampled(site, p, self._block_masks(masks, site),
                                     op_idx.clamp(max=ss.NUM_OPS - 1), x,
                                     training)
            return torch.where(op_idx == hs.VIT_OP_IDX, vit(p, masks, x), mb)
        return self._maybe_remat(fn)

    def _soft_block_fn(self, site, training):
        if site.global_idx not in self.vit:
            conv = super()._soft_block_fn(site, training)
            # w[8] == 0 here by the validity mask, and w[:8] sums to 1
            return lambda p, masks, w, x: conv(p, masks, w[:ss.NUM_OPS], x)
        vit = self._vit_fn(site, training)

        def fn(p, masks, w, x):
            mb = self._block_soft(site, p, self._block_masks(masks, site),
                                  w[:ss.NUM_OPS], x, training)
            w8 = w[hs.VIT_OP_IDX].to(mb.dtype)
            y = mb + w8 * vit(p, masks, x)
            if site.has_residual:
                y = y - w8 * x
            return y
        return self._maybe_remat(fn)

    def apply_multi_sampled(self, *a, **kw):
        raise NotImplementedError(
            "the grouped multi-sample variant is conv-space only; the "
            "hybrid space uses apply_sampled_pair")
