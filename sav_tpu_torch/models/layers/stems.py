"""Patch tokenization stem (port of ``sav_tpu/models/layers/stems.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
