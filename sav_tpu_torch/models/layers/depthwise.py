"""Depthwise 2-D convolution (port of ``sav_tpu/models/layers/depthwise.py``).

``sav_tpu`` unrolls the conv into k² shifted taps: each tap, cast up to
f32, times the **f32 kernel**, summed in f32, and only the sum cast to the
compute dtype. The kernel is never rounded to bf16, unlike a
``nn.Conv(dtype=bf16)``. The port computes the same function as one
grouped f32 convolution, ``F.conv2d(x.float(), w_f32, groups=C)``, cast
after: the same products and an f32 sum in another order. On the card
cuDNN may run an f32 convolution in TF32 (``torch.backends.cudnn.allow_tf32``
defaults to True), which would round both operands to 10 mantissa bits, so
the conv runs under a scoped ``torch.backends.cudnn.flags`` with TF32 off.

Consumers: CvT's conv projections (:mod:`.cvt_attention`) and CeiT's LeFF
(:mod:`.feedforward`). The conv is outside every kernel of ``sav_tpu``
(XLA work there), so it is a cuDNN/PyTorch call here, not a kernel port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.convolution import _pad_same
from sav_tpu_torch.models.layers.initializers import lecun_normal_


def exact_f32_conv():
    """A scoped ``torch.backends.cudnn.flags`` that keeps the other cuDNN
    flags as they stand and turns TF32 off."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class DepthwiseConv2D(nn.Module):
    """NHWC ``[B, H, W, C] -> [B, H', W', C]`` depthwise conv with flax's
    ``SAME`` padding (``H' = ceil(H / stride)``; asymmetric at stride 2)
    and no bias, in f32 with the f32 kernel, the output in the input's
    dtype. ``weight`` is ``[C, 1, kh, kw]`` where flax's ``kernel`` is
    ``[kh, kw, 1, C]``; it stays f32 under ``cast_for_compute``."""

    F32_TENSORS = ("weight",)

    def __init__(self, features: int, kernel_size=(3, 3), stride: int = 1):
        super().__init__()
        kh, kw = kernel_size
        if kh != kw:
            raise ValueError(f"a square kernel is ported, got {kernel_size}")
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(features, 1, kh, kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun-normal (truncated) over the fan-in ``kh·kw``."""
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs.permute(0, 3, 1, 2).float()  # an [N, C, H, W] channels_last view
        x, padding = _pad_same(x, self.weight.shape[-1], self.stride, 0.0)
        with exact_f32_conv():
            out = F.conv2d(x, self.weight.float(), None, self.stride, padding,
                           groups=self.weight.shape[0])
        return out.to(inputs.dtype).permute(0, 2, 3, 1)
