"""Tokenization stems (port of ``sav_tpu/models/layers/stems.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.convolution import SameConv2d, max_pool_same
from sav_tpu_torch.models.layers.normalization import BatchNorm


class PatchEmbedBlock(nn.Module):
    """Non-overlapping patch embedding: NHWC ``[B, H, W, C]`` →
    ``[B, (H/ph)(W/pw), D]``, tokens in row-major patch order as in
    ``sav_tpu`` (a strided conv; its weight is OIHW where flax's is HWIO),
    computed in the input's dtype with the weight cast at use."""

    def __init__(self, patch_shape, embed_dim: int, in_ch: int = 3, use_bias: bool = True):
        super().__init__()
        self.patch_shape = tuple(patch_shape)
        self.proj = nn.Conv2d(
            in_ch, embed_dim, kernel_size=self.patch_shape,
            stride=self.patch_shape, bias=use_bias,
        )

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        ph, pw = self.patch_shape
        _, h, w, _ = inputs.shape
        if h % ph or w % pw:
            raise ValueError(f"image {h}x{w} not divisible by patch {self.patch_shape}")
        proj = self.proj
        bias = None if proj.bias is None else proj.bias.to(inputs.dtype)
        x = F.conv2d(
            inputs.permute(0, 3, 1, 2), proj.weight.to(inputs.dtype), bias,
            stride=proj.stride,
        )
        return x.flatten(2).transpose(1, 2)


class Image2TokenBlock(nn.Module):
    """CeiT's conv stem, NHWC ``[B, H, W, 3]`` → ``[B, L, D]``: a 7×7/2
    ``SAME`` conv without bias, BatchNorm (no activation), a 3×3/2 ``SAME``
    max pool (padded with −inf), then the patch embedding. At 224² the map
    goes 224 → 112 → 56, and 4×4 patches give 14×14 tokens."""

    def __init__(self, patch_shape, embed_dim: int, stem_ch: int = 32, in_ch: int = 3):
        super().__init__()
        self.stem_conv = SameConv2d(in_ch, stem_ch, 7, 2)
        self.stem_bn = BatchNorm(stem_ch)
        self.patch_embed = PatchEmbedBlock(patch_shape, embed_dim, in_ch=stem_ch)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs.permute(0, 3, 1, 2)  # NHWC → an [N, C, H, W] channels_last view
        x = max_pool_same(self.stem_bn(self.stem_conv(x)), 3, 2)
        return self.patch_embed(x.permute(0, 2, 3, 1))
