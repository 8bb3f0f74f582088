"""CeiT — Convolution-enhanced image Transformer (port of ``sav_tpu/models/ceit.py``).

The Image-to-Token conv stem (:class:`Image2TokenBlock`), a CLS token and
learned absolute position embeddings, post-norm encoder blocks whose
feed-forward is the locally-enhanced :class:`LeFFBlock` (a depthwise conv
on the token grid between BatchNorms), the collection of every block's CLS
token, and the layer-wise class attention over them
(:class:`LCSelfAttentionBlock`: the last block's CLS token attends over all
of them), LayerNorm and a zero-init head. Inputs are NHWC, as in
``sav_tpu``; parameters stay in their own dtype and every layer computes in
its input's (BatchNorm statistics and the depthwise conv in f32).

At CeiT-S's 224² the trunk attends over ``1 + 14²`` tokens (6 heads of 64)
and the class attention one query over 12 collected tokens: the fused
kernels' shapes under ``auto``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.layers import (
    AddAbsPosEmbed,
    AttentionBlock,
    BatchNorm,
    ConvProjectionBlock,
    CvTAttentionBlock,
    DepthwiseConv2D,
    Dropout,
    Image2TokenBlock,
    LCSelfAttentionBlock,
    LeFFBlock,
    SelfAttentionBlock,
    dense,
)
from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.vit import LayerNorm, refuse_unported

# sav_tpu CeiT options this port does not carry yet, and the ROADMAP item
# each waits on. Setting one raises NotImplementedError.
_NOT_PORTED = {
    "seq_parallel": "queue A9 (parallelism)",
    "seq_mesh": "queue A9 (parallelism)",
}


def token_grid(image_size: int, patch_shape) -> int:
    """The side of CeiT's token grid: the stem's 7×7/2 conv and 3×3/2 max
    pool halve the image (``ceil``), then the patches divide it."""
    size = image_size
    for _ in range(2):
        size = -(-size // 2)
    ph, pw = patch_shape
    if ph != pw or size % ph:
        raise ValueError(f"the stem's {size}x{size} map is not divisible by patch {patch_shape}")
    return size // ph


def reset_conv_model(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers from an explicit generator, for CeiT, CvT, TNT
    and MLP-Mixer: lecun-normal (truncated) kernels (the depthwise convs' and the
    projections' too), zero biases, unit LayerNorm scales, BatchNorm at
    flax's init, normal(0.02) position tables; then a zero head. The CLS
    tokens are left to the model."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            lecun_normal_(module.weight, module.weight[0].numel(), generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, BatchNorm):
            module.reset_parameters()
        elif isinstance(module, (AttentionBlock, CvTAttentionBlock, ConvProjectionBlock,
                                 DepthwiseConv2D, AddAbsPosEmbed)):
            module.reset_parameters(generator)
    nn.init.zeros_(model.head.weight)
    nn.init.zeros_(model.head.bias)


class EncoderBlock(nn.Module):
    """Post-norm block: SA → residual → LN, then LeFF → residual → LN."""

    def __init__(self, dim: int, num_heads: int, *, expand_ratio: float = 4.0,
                 backend: Optional[str] = None, logits_dtype=None,
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        self.attn = SelfAttentionBlock(
            dim, num_heads, backend=backend, logits_dtype=logits_dtype,
            attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate, quant=quant,
        )
        self.norm1 = LayerNorm(dim)
        self.leff = LeFFBlock(dim, expand_ratio=expand_ratio, quant=quant)
        self.norm2 = LayerNorm(dim)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.norm1(self.attn(inputs) + inputs)
        return self.norm2(self.leff(x) + x)


class CeiT(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.

    ``image_size`` fixes the position table's length at construction
    (flax reads it from the init input)."""

    def __init__(
        self,
        num_classes: int,
        embed_dim: int,
        num_layers: int,
        num_heads: int,
        patch_shape,
        *,
        image_size: int = 224,
        stem_ch: int = 32,
        expand_ratio: float = 4.0,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("CeiT", unported, _NOT_PORTED)
        self.quant = quant
        self.image_size = image_size
        side = token_grid(image_size, patch_shape)
        self.stem = Image2TokenBlock(patch_shape, embed_dim, stem_ch)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = AddAbsPosEmbed(1 + side * side, embed_dim)
        self.pos_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, expand_ratio=expand_ratio, backend=backend,
                         logits_dtype=logits_dtype, attn_dropout_rate=attn_dropout_rate,
                         dropout_rate=dropout_rate, quant=quant)
            for _ in range(num_layers)
        )
        self.lca = LCSelfAttentionBlock(embed_dim, num_heads, backend=backend,
                                        logits_dtype=logits_dtype,
                                        attn_dropout_rate=attn_dropout_rate, quant=quant)
        self.norm = LayerNorm(embed_dim)
        self.head = dense(embed_dim, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """:func:`reset_conv_model`, and a zero CLS token."""
        reset_conv_model(self, generator)
        nn.init.zeros_(self.cls)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.stem(inputs)
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.pos_drop(self.pos_embed(torch.cat([cls, x], dim=1)))
        collected = []
        for block in self.blocks:
            x = block(x)
            collected.append(x[:, 0])
        out = self.lca(torch.stack(collected, dim=1))  # [B, 1, D]: the last token's
        return self.head(self.norm(out[:, -1]))
