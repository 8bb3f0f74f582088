"""TNT — Transformer-in-Transformer (port of ``sav_tpu/models/tnt.py``).

Two token streams. Each image patch becomes a grid of "pixel" tokens
(:class:`PixelEmbedBlock`: a 7×7/4 ``SAME`` conv on the patch), folded into
the batch as ``[B·P, inner_tokens, inner_ch]``; the patches themselves are
the outer tokens ``[B, 1 + P, embed_dim]`` with a CLS token. Every
:class:`EncoderBlock` runs a pre-LN transformer on the pixel stream, folds
it into the patch tokens (:class:`Inner2OuterBlock`), then runs a pre-LN
transformer on the patch stream. Inputs are NHWC, as in ``sav_tpu``;
parameters stay in their own dtype and every layer computes in its
input's.

At TNT-S's 224² the inner attention runs 16 tokens of 4 heads of 6 (TNT-B:
of 10) over ``B·196`` slices, the outer one DeiT-S's shape (197 tokens, 6
heads of 64). The fused kernels take both under ``auto``: the inner head
dims zero-padded to 8 and 16 in their wrappers
(:func:`~sav_tpu_torch.ops.fused_attention.pad_head_dim`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.ceit import reset_conv_model
from sav_tpu_torch.models.layers import (
    AddAbsPosEmbed,
    Dense,
    Dropout,
    FFBlock,
    PatchEmbedBlock,
    SameConv2d,
    SelfAttentionBlock,
    dense,
)
from sav_tpu_torch.models.layers.depthwise import exact_f32_conv
from sav_tpu_torch.models.vit import LayerNorm, refuse_unported

# sav_tpu TNT options this port does not carry yet, and the ROADMAP item
# each waits on. Setting one raises NotImplementedError.
_NOT_PORTED = {
    "seq_parallel": "queue A9 (parallelism)",
    "seq_mesh": "queue A9 (parallelism)",
}


def inner_grid(patch_shape, inner_stride: int = 4) -> tuple:
    """The pixel tokens of one patch, ``(rows, cols)``: the ``SAME`` conv's
    output, ``ceil(ph / stride) × ceil(pw / stride)`` (4 × 4 at patch 16)."""
    ph, pw = patch_shape
    return -(-ph // inner_stride), -(-pw // inner_stride)


class PixelEmbedBlock(nn.Module):
    """NHWC ``[B, H, W, C]`` → pixel tokens ``[B·P, inner_tokens, inner_ch]``:
    the patches in flax's order (patch rows, then patch columns), each a
    ``ph × pw`` image through a 7×7 ``SAME`` conv of stride
    ``inner_stride`` with bias (at 16×16 and stride 4 its pads are (1, 2)
    on both axes), the conv's map read row-major. The conv runs with
    cuDNN's TF32 off, so f32 inputs are convolved in f32."""

    def __init__(self, patch_shape, inner_ch: int, inner_stride: int = 4, in_ch: int = 3):
        super().__init__()
        self.patch_shape = tuple(patch_shape)
        self.proj = SameConv2d(in_ch, inner_ch, 7, inner_stride, bias=True)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, h, w, c = inputs.shape
        ph, pw = self.patch_shape
        if h % ph or w % pw:
            raise ValueError(f"image {h}x{w} not divisible by patch {self.patch_shape}")
        x = inputs.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(-1, ph, pw, c).permute(0, 3, 1, 2)  # an [N, C, H, W] channels_last view
        with exact_f32_conv():
            x = self.proj(x)
        return x.flatten(2).transpose(1, 2)


class Inner2OuterBlock(nn.Module):
    """Fold the pixel tokens into the patch tokens: each patch's
    ``[inner_tokens, inner_ch]`` flattened token-major (``inner_tokens ·
    inner_ch`` features), LayerNorm'd and projected to ``embed_dim``, then
    added to the patch tokens past CLS. ``sav_tpu`` adds with
    ``.at[:, 1:].add``; here the CLS row is joined to the sum, so no tensor
    autograd saved is written in place."""

    def __init__(self, inner_features: int, embed_dim: int):
        super().__init__()
        self.norm = LayerNorm(inner_features)
        self.proj = Dense(inner_features, embed_dim)

    def forward(self, pixel_tokens: torch.Tensor, patch_tokens: torch.Tensor) -> torch.Tensor:
        b, length, _ = patch_tokens.shape
        fold = self.proj(self.norm(pixel_tokens.reshape(b, length - 1, -1)))
        return torch.cat([patch_tokens[:, :1], patch_tokens[:, 1:] + fold], dim=1)


class EncoderBlock(nn.Module):
    """The inner transformer (pre-LN attention and FF) on the pixel stream,
    the fold into the patch stream, then the outer transformer on it.
    Returns ``(pixel_tokens, patch_tokens)``."""

    def __init__(self, embed_dim: int, inner_ch: int, inner_tokens: int, num_heads: int,
                 inner_num_heads: int, *, expand_ratio: float = 4.0,
                 inner_expand_ratio: float = 4.0, backend: Optional[str] = None,
                 logits_dtype=None, attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        attn = dict(backend=backend, logits_dtype=logits_dtype,
                    attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate,
                    quant=quant)
        self.inner_norm1 = LayerNorm(inner_ch)
        self.inner_attn = SelfAttentionBlock(inner_ch, inner_num_heads, **attn)
        self.inner_norm2 = LayerNorm(inner_ch)
        self.inner_ff = FFBlock(inner_ch, expand_ratio=inner_expand_ratio,
                                dropout_rate=dropout_rate, quant=quant)
        self.inner2outer = Inner2OuterBlock(inner_tokens * inner_ch, embed_dim)
        self.outer_norm1 = LayerNorm(embed_dim)
        self.outer_attn = SelfAttentionBlock(embed_dim, num_heads, **attn)
        self.outer_norm2 = LayerNorm(embed_dim)
        self.outer_ff = FFBlock(embed_dim, expand_ratio=expand_ratio, dropout_rate=dropout_rate,
                                quant=quant)

    def forward(self, pixel_tokens: torch.Tensor, patch_tokens: torch.Tensor) -> tuple:
        x = pixel_tokens + self.inner_attn(self.inner_norm1(pixel_tokens))
        pixel_tokens = x + self.inner_ff(self.inner_norm2(x))
        patch_tokens = self.inner2outer(pixel_tokens, patch_tokens)
        z = patch_tokens + self.outer_attn(self.outer_norm1(patch_tokens))
        return pixel_tokens, z + self.outer_ff(self.outer_norm2(z))


class TNT(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.

    ``image_size`` fixes the outer position table's length at construction
    (flax reads it from the init input). Dropout acts on the patch stream
    after its position table, and in every attention and FF block of both
    streams."""

    def __init__(
        self,
        num_classes: int,
        embed_dim: int,
        inner_ch: int,
        num_layers: int,
        num_heads: int,
        inner_num_heads: int,
        patch_shape,
        *,
        image_size: int = 224,
        inner_stride: int = 4,
        expand_ratio: float = 4.0,
        inner_expand_ratio: float = 4.0,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("TNT", unported, _NOT_PORTED)
        self.quant = quant
        ph, pw = patch_shape
        if image_size % ph or image_size % pw:
            raise ValueError(f"image {image_size} not divisible by patch {patch_shape}")
        self.image_size = image_size
        rows, cols = inner_grid(patch_shape, inner_stride)
        inner_tokens = rows * cols
        num_patches = (image_size // ph) * (image_size // pw)
        self.pixel_embed = PixelEmbedBlock(patch_shape, inner_ch, inner_stride)
        self.patch_embed = PatchEmbedBlock(patch_shape, embed_dim)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.inner_pos_embed = AddAbsPosEmbed(inner_tokens, inner_ch)
        self.outer_pos_embed = AddAbsPosEmbed(1 + num_patches, embed_dim)
        self.pos_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, inner_ch, inner_tokens, num_heads, inner_num_heads,
                         expand_ratio=expand_ratio, inner_expand_ratio=inner_expand_ratio,
                         backend=backend, logits_dtype=logits_dtype,
                         attn_dropout_rate=attn_dropout_rate, dropout_rate=dropout_rate,
                         quant=quant)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(embed_dim)
        self.head = dense(embed_dim, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """:func:`~sav_tpu_torch.models.ceit.reset_conv_model`, and a zero
        CLS token."""
        reset_conv_model(self, generator)
        nn.init.zeros_(self.cls)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        pixel_tokens = self.inner_pos_embed(self.pixel_embed(inputs))
        patch_tokens = self.patch_embed(inputs)
        cls = self.cls.to(patch_tokens.dtype).expand(patch_tokens.shape[0], 1, -1)
        patch_tokens = self.pos_drop(self.outer_pos_embed(torch.cat([cls, patch_tokens], dim=1)))
        for block in self.blocks:
            pixel_tokens, patch_tokens = block(pixel_tokens, patch_tokens)
        return self.head(self.norm(patch_tokens[:, 0]))
