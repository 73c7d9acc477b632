from .activations import ACT_FNS, apply_act, get_act_fn, hard_swish, relu, relu6, swish
from .batchnorm import BN_EPS, BN_MOMENTUM, batch_norm, init_bn, stat_dtype
from .conv import (channel_shuffle, conv2d, global_avg_pool,
                   init_conv_kernel, init_linear, linear, torch_uniform_init)
from .layers import (ConvLayer, IdentityLayer, LinearLayer,
                     MBInvertedResBlock, drop_connect, set_layer_from_config)
from .attention import ViTBlock, layer_norm, multi_head_attention

__all__ = [
    "ACT_FNS", "apply_act", "get_act_fn", "hard_swish", "relu", "relu6",
    "swish", "BN_EPS", "BN_MOMENTUM", "batch_norm", "init_bn", "stat_dtype",
    "channel_shuffle", "conv2d", "global_avg_pool", "init_conv_kernel",
    "init_linear", "linear", "torch_uniform_init", "ConvLayer",
    "IdentityLayer", "LinearLayer", "MBInvertedResBlock", "drop_connect",
    "set_layer_from_config", "ViTBlock", "layer_norm",
    "multi_head_attention",
]
