"""The control's precision: the reference computed one step below the
configuration's bfloat16, in float8 (e4m3, a scale per tensor so that its
largest magnitude lands on the format's largest value, 448). Every
operand of a convolution or matrix product is rounded so; the rounding
passes gradients straight through. Used as a context:

    with lowp.float8():
        ... the reference's forward and backward ...
"""

from __future__ import annotations

import contextlib

import torch

from . import nn

E4M3_MAX = 448.0


def round_float8(t):
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


@contextlib.contextmanager
def float8():
    prev = nn.LOWP["round"]
    nn.LOWP["round"] = round_float8
    try:
        yield
    finally:
        nn.LOWP["round"] = prev
