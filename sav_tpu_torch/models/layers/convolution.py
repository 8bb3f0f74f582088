"""Convolution and pooling with flax's (TF-style) ``padding="SAME"``.

flax pads ``SAME`` as ``lax.padtype_to_pads`` does: the output is
``ceil(size / stride)`` and the total padding ``max((out − 1)·stride + k −
size, 0)`` is split ``lo = total // 2``, ``hi = total − lo``. At stride 2 the
split is asymmetric: the 7×7/2 stem conv on 224² pads (2, 3), the 3×3/2 max
pool on 112² and a 3×3/2 conv on 56² pad (0, 1). ``nn.Conv2d(padding=k//2)``
and ``nn.MaxPool2d(padding=1)`` give the same output shapes with every
window shifted by one pixel, so :func:`same_pads` is used at every conv and
pool with a stride. Convs pad with zeros, the max pool with −inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """flax's ``(lo, hi)`` ``SAME`` padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float):
    """``x`` ``[N, C, H, W]`` padded for a ``SAME`` window; returns it and
    the symmetric padding left for the op itself (where lo == hi on both
    axes no copy is made)."""
    (top, bottom), (left, right) = (same_pads(s, kernel, stride) for s in x.shape[2:])
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


class SameConv2d(nn.Conv2d):
    """A square-kernel conv with ``SAME`` padding, without bias unless
    ``bias`` (CvT's token embedding has one), computed in the input's dtype
    (the weight, OIHW where flax's is HWIO, and the bias cast at use)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, *,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x, padding = _pad_same(inputs, self.kernel_size[0], self.stride[0], 0.0)
        bias = None if self.bias is None else self.bias.to(inputs.dtype)
        return F.conv2d(x, self.weight.to(inputs.dtype), bias, self.stride, padding)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: padded
    with −inf, so a window over the edge takes the largest real value."""
    x, padding = _pad_same(x, kernel, stride, float("-inf"))
    return F.max_pool2d(x, kernel, stride, padding)
