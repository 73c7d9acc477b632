from .fused_dw import FusedDwNormAct, fold_bn_mask, fused_dw_norm_act

__all__ = ["FusedDwNormAct", "fold_bn_mask", "fused_dw_norm_act"]
