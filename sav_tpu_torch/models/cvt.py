"""CvT — Convolutional vision Transformer (port of ``sav_tpu/models/cvt.py``).

Three stages, each a strided ``SAME`` conv token embedding (with bias, then
LayerNorm) and pre-LN blocks of conv-projection attention
(:class:`CvTSelfAttentionBlock`: K and V strided 2×) and an MLP. The CLS
token joins in the last stage only; between stages the tokens are put back
on their grid for the next embedding. No position embedding. The head reads
the LayerNorm of the CLS token; it starts at zero. Inputs are NHWC, as in
``sav_tpu``; parameters stay in their own dtype and every layer computes in
its input's (BatchNorm statistics and the depthwise convs in f32).

At CvT-13's 224² the grids are 56², 28² and 14², so the attention cores
see 3,136 queries over 784 keys (1 head of 64), 784 over 196 (3 heads) and
197 over 50 (6 heads): under ``auto`` stage 1 takes the flash kernels
(kv 784 is above the fused forward's band) and stages 2 and 3 the fused
ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.ceit import reset_conv_model
from sav_tpu_torch.models.layers import CvTSelfAttentionBlock, FFBlock, SameConv2d, dense
from sav_tpu_torch.models.vit import LayerNorm, refuse_unported

# sav_tpu CvT options this port does not carry yet (none); any other name
# raises TypeError.
_NOT_PORTED: dict = {}


class ConvTokenEmbedBlock(nn.Module):
    """NHWC ``[B, H, W, C]`` → tokens ``[B, h·w, D]`` and ``(h, w)``: a
    strided ``SAME`` conv with bias, flattened, then LayerNorm."""

    def __init__(self, in_ch: int, embed_dim: int, kernel_size, stride: int):
        super().__init__()
        kh, kw = kernel_size
        if kh != kw:
            raise ValueError(f"a square kernel is ported, got {kernel_size}")
        self.proj = SameConv2d(in_ch, embed_dim, kh, stride, bias=True)
        self.norm = LayerNorm(embed_dim)

    def forward(self, inputs: torch.Tensor):
        x = self.proj(inputs.permute(0, 3, 1, 2))  # an [N, C, H, W] channels_last view
        b, c, h, w = x.shape
        return self.norm(x.permute(0, 2, 3, 1).reshape(b, h * w, c)), (h, w)


class StageBlock(nn.Module):
    """Pre-LN: LN → conv-projection attention → residual, LN → MLP →
    residual."""

    def __init__(self, dim: int, num_heads: int, *, expand_ratio: float = 4.0,
                 with_cls: bool = False, backend: Optional[str] = None, logits_dtype=None,
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = CvTSelfAttentionBlock(
            dim, num_heads, with_cls=with_cls, backend=backend, logits_dtype=logits_dtype,
            attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate, quant=quant,
        )
        self.norm2 = LayerNorm(dim)
        self.ff = FFBlock(dim, expand_ratio=expand_ratio, dropout_rate=dropout_rate, quant=quant)

    def forward(self, tokens: torch.Tensor, grid_shape) -> torch.Tensor:
        tokens = tokens + self.attn(self.norm1(tokens), grid_shape)
        return tokens + self.ff(self.norm2(tokens))


class Stage(nn.Module):
    """The token embedding, a zero-init CLS token in front (``insert_cls``),
    then ``num_layers`` blocks; returns the tokens and their grid."""

    def __init__(self, in_ch: int, embed_dim: int, num_layers: int, num_heads: int,
                 kernel_size, stride: int, *, insert_cls: bool = False, **block_kw):
        super().__init__()
        self.insert_cls = insert_cls
        self.embed = ConvTokenEmbedBlock(in_ch, embed_dim, kernel_size, stride)
        if insert_cls:
            self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            StageBlock(embed_dim, num_heads, with_cls=insert_cls, **block_kw)
            for _ in range(num_layers)
        )

    def forward(self, inputs: torch.Tensor):
        tokens, grid_shape = self.embed(inputs)
        if self.insert_cls:
            cls = self.cls.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        for block in self.blocks:
            tokens = block(tokens, grid_shape)
        return tokens, grid_shape


class CvT(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.
    ``image_size`` is kept for callers that draw images for the model (CvT
    has no position table to size)."""

    def __init__(
        self,
        num_classes: int,
        embed_dims=(64, 192, 384),
        num_layers=(1, 2, 10),
        num_heads=(1, 3, 6),
        strides=(4, 2, 2),
        kernel_sizes=((7, 7), (3, 3), (3, 3)),
        *,
        image_size: int = 224,
        expand_ratio: float = 4.0,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("CvT", unported, _NOT_PORTED)
        self.quant = quant
        self.image_size = image_size
        in_chs = (3, *embed_dims[:2])
        self.stages = nn.ModuleList(
            Stage(in_chs[s], embed_dims[s], num_layers[s], num_heads[s], kernel_sizes[s],
                  strides[s], insert_cls=s == 2, expand_ratio=expand_ratio, backend=backend,
                  logits_dtype=logits_dtype, attn_dropout_rate=attn_dropout_rate,
                  dropout_rate=dropout_rate, quant=quant)
            for s in range(3)
        )
        self.norm = LayerNorm(embed_dims[2])
        self.head = dense(embed_dims[2], num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """CeiT's :func:`~sav_tpu_torch.models.ceit.reset_conv_model`, and a
        zero CLS token."""
        reset_conv_model(self, generator)
        nn.init.zeros_(self.stages[2].cls)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs
        for stage in self.stages:
            tokens, (h, w) = stage(x)
            if not stage.insert_cls:
                x = tokens.reshape(tokens.shape[0], h, w, -1)  # back on the grid
        return self.head(self.norm(tokens[:, 0]))
