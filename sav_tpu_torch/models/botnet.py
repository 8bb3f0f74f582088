"""BoTNet — Bottleneck Transformers (port of ``sav_tpu/models/botnet.py``).

A ResNet-50-style backbone of bottleneck blocks with BatchNorm, swish and
squeeze-excite; the last stage replaces the 3×3 conv with 2-D
relative-position self-attention (:class:`BoTMHSA`), its stride a 2×2
average pool after the attention. Each attention core runs the
relative-position kernels (:mod:`sav_tpu_torch.ops.flash_attention`, #6–#8).

Layout: the inputs are NHWC, as in ``sav_tpu``, and the model works on
``[N, C, H, W]`` views of them in channels_last memory: the permute of the
NHWC input is free, cuDNN's bf16 convolutions take NHWC, and the attention's
``[B, L, heads, D]`` token view of a feature map is a free reshape.

Numerics kept from flax: TF-style ``SAME`` padding at every strided conv and
pool (:mod:`sav_tpu_torch.models.layers.convolution`), BatchNorm's momentum
0.9, biased running variance and f32 statistics
(:class:`~sav_tpu_torch.models.layers.BatchNorm`), and the zero init of each
block's ``bn3`` scale and of the head: at init every residual branch and
every logit is 0.

The relative tables' sizes depend on the grid each attention block sees, so
the model takes ``image_size`` and fixes the grids at construction
(:func:`attention_grids`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers import (
    BatchNorm,
    BoTMHSA,
    SameConv2d,
    SqueezeExciteBlock,
    dense,
    max_pool_same,
)
from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.vit import refuse_unported

# sav_tpu BoTNet options this port does not carry yet (none); any other name
# raises TypeError.
_NOT_PORTED: dict = {}

FILTERS = (64, 128, 256, 512)


def _down(size: int) -> int:
    """A stride-2 ``SAME`` conv or pool: ``ceil(size / 2)``."""
    return -(-size // 2)


def attention_grids(image_size: int, stage_sizes) -> list:
    """The ``(height, width)`` each stage-4 block attends over: the stem's
    conv and max pool and the first block of each later stage halve the map
    (``ceil``), stage 4's first block attends, then pools 2×2 (VALID)."""
    size = _down(_down(image_size))
    for stage in (1, 2):
        if stage_sizes[stage]:
            size = _down(size)
    grids = []
    for block in range(stage_sizes[3]):
        grids.append((size, size))
        if block == 0:
            size //= 2
    return grids


class BottleneckResNetBlock(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 convs with BatchNorm and swish, optional
    squeeze-excite after the 3×3, zero-init ``bn3`` scale, and a projected
    residual where the shape changes."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 se_ratio: Optional[float] = 0.25):
        super().__init__()
        self.conv1 = SameConv2d(in_ch, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.se = None if se_ratio is None else SqueezeExciteBlock(filters, se_ratio)
        self.conv3 = SameConv2d(filters, 4 * filters, 1)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True)
        self.proj = in_ch != 4 * filters or strides != 1
        if self.proj:
            self.proj_conv = SameConv2d(in_ch, 4 * filters, 1, strides)
            self.proj_bn = BatchNorm(4 * filters)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv1(inputs)))
        x = F.silu(self.bn2(self.conv2(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv3(x))
        residual = self.proj_bn(self.proj_conv(inputs)) if self.proj else inputs
        return F.silu(x + residual)


class BoTBlock(nn.Module):
    """The bottleneck with its 3×3 conv replaced by :class:`BoTMHSA`; the
    stride is a 2×2 average pool after the attention."""

    def __init__(self, in_ch: int, filters: int, grid, *, num_heads: int = 4,
                 strides: int = 1, backend: Optional[str] = None, logits_dtype=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.strides = strides
        self.conv1 = SameConv2d(in_ch, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.mhsa = BoTMHSA(filters, num_heads, *grid, head_ch=filters // num_heads,
                            backend=backend, logits_dtype=logits_dtype, quant=quant)
        self.bn2 = BatchNorm(filters)
        self.conv3 = SameConv2d(filters, 4 * filters, 1)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True)
        self.proj = in_ch != 4 * filters or strides != 1
        if self.proj:
            self.proj_conv = SameConv2d(in_ch, 4 * filters, 1, strides)
            self.proj_bn = BatchNorm(4 * filters)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv1(inputs)))
        x = self.mhsa(x)
        if self.strides == 2:
            x = F.avg_pool2d(x, 2, 2)
        x = F.silu(self.bn2(x))
        x = self.bn3(self.conv3(x))
        residual = self.proj_bn(self.proj_conv(inputs)) if self.proj else inputs
        return F.silu(x + residual)


class BoTNet(nn.Module):
    """inputs ``[B, H, W, 3]`` NHWC → logits ``[B, num_classes]``.

    Blocks are named as in the flax tree (``stem_conv``, ``stem_bn``,
    ``stage{s}_block{b}``, ``head``), so ``sav_tpu_torch.interop`` converts
    by name."""

    def __init__(
        self,
        num_classes: int,
        stage_sizes=(3, 4, 6, 6),
        *,
        num_heads: int = 4,
        se_ratio: Optional[float] = 0.25,
        image_size: int = 224,
        backend: Optional[str] = None,
        logits_dtype=None,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("BoTNet", unported, _NOT_PORTED)
        self.quant = quant
        stage_sizes = tuple(stage_sizes)
        if len(stage_sizes) != 4:
            raise ValueError(f"stage_sizes must have 4 entries, got {stage_sizes}")
        self.stage_sizes = stage_sizes
        self.image_size = image_size
        self.stem_conv = SameConv2d(3, FILTERS[0], 7, 2)
        self.stem_bn = BatchNorm(FILTERS[0])
        self.block_names = []
        in_ch = FILTERS[0]
        for stage in range(3):
            for block in range(stage_sizes[stage]):
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, BottleneckResNetBlock(
                    in_ch, FILTERS[stage], 2 if stage > 0 and block == 0 else 1, se_ratio))
                self.block_names.append(name)
                in_ch = 4 * FILTERS[stage]
        for block, grid in enumerate(attention_grids(image_size, stage_sizes)):
            name = f"stage4_block{block}"
            self.add_module(name, BoTBlock(
                in_ch, FILTERS[3], grid, num_heads=num_heads, strides=2 if block == 0 else 1,
                backend=backend, logits_dtype=logits_dtype, quant=quant))
            self.block_names.append(name)
            in_ch = 4 * FILTERS[3]
        self.head = dense(in_ch, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers from an explicit generator: lecun-normal
        (truncated) conv, Dense and projection kernels, zero biases,
        BatchNorm scale 1 (``bn3`` 0), bias 0, running mean 0 and variance
        1, normal relative tables, and a zero head."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
            elif isinstance(module, BoTMHSA):
                module.reset_parameters(generator)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs.permute(0, 3, 1, 2)  # NHWC → an [N, C, H, W] channels_last view
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))
