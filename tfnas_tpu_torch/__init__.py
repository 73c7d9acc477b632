"""TF-NAS on PyTorch and CUDA: the H100 counterpart of `tfnas_tpu`.

The package mirrors `tfnas_tpu`'s module layout so that each counterpart is
easy to find, but imports only `torch` and `numpy`. Public functions keep the
JAX package's layouts (activations `[N, H, W, C]`); inside, activations are
logical NCHW tensors in `channels_last` memory and convolution kernels are
OIHW (`convert.py` maps JAX parameter trees to and from this layout).

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
