"""CaiT — Class-Attention in Image Transformers (port of ``sav_tpu/models/cait.py``).

A trunk of talking-heads self-attention blocks with LayerScale and
stochastic depth over the patch tokens (no CLS token), then class-attention
blocks that update only a CLS token created after the trunk, a final
LayerNorm on it and a zero-init head. Each trunk attention core runs the
talking-heads kernels (:mod:`sav_tpu_torch.ops.talking_heads`); each
class-attention core is one query row over ``[CLS; tokens]`` through the
seam of :mod:`sav_tpu_torch.ops.attention` (the fused kernels).

As in the ViT, parameters stay in their own dtype and every layer computes
in the dtype of its input. Stochastic depth draws from the generator
:func:`~sav_tpu_torch.models.layers.regularization.set_stochastic_depth_generator`
gives it, dropout from the one
:func:`~sav_tpu_torch.models.layers.regularization.set_dropout_generator`
gives it (the Trainer seeds both from its config). ``dropout_rate`` drops
after the position embedding and in every block's attention output and FF,
``attn_dropout_rate`` the attention probabilities of every block, talking
heads and class attention alike, on the dense paths.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.layers import (
    AddAbsPosEmbed,
    AttentionBlock,
    ClassSelfAttentionBlock,
    Dropout,
    FFBlock,
    LayerScaleBlock,
    PatchEmbedBlock,
    SelfAttentionBlock,
    StochasticDepthBlock,
    dense,
)
from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.vit import LayerNorm, refuse_unported

# sav_tpu CaiT options this port does not carry yet, and the ROADMAP item
# each waits on. Setting one raises NotImplementedError.
_NOT_PORTED = {
    "seq_parallel": "queue A9 (parallelism)",
    "seq_mesh": "queue A9 (parallelism)",
}


class EncoderBlock(nn.Module):
    """Talking-heads self-attention and FF, each branch LayerScaled and
    stochastically dropped before its residual add."""

    def __init__(self, dim: int, num_heads: int, *, expand_ratio: float = 4.0,
                 layerscale_eps: float = 1e-5, stoch_depth_rate: float = 0.0,
                 backend: Optional[str] = None, logits_dtype=None,
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttentionBlock(
            dim, num_heads, talking_heads=True, backend=backend, logits_dtype=logits_dtype,
            attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate, quant=quant,
        )
        self.ls1 = LayerScaleBlock(dim, layerscale_eps)
        self.sd1 = StochasticDepthBlock(stoch_depth_rate)
        self.norm2 = LayerNorm(dim)
        self.ff = FFBlock(dim, expand_ratio=expand_ratio, dropout_rate=dropout_rate, quant=quant)
        self.ls2 = LayerScaleBlock(dim, layerscale_eps)
        self.sd2 = StochasticDepthBlock(stoch_depth_rate)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.sd1(self.ls1(self.attn(self.norm1(inputs)))) + inputs
        return x + self.sd2(self.ls2(self.ff(self.norm2(x))))


class CAEncoderBlock(nn.Module):
    """Class-attention block: the CLS token attends over ``[CLS; tokens]``
    and only the CLS token is updated. The class-attention stage runs
    undropped, as in ``sav_tpu``."""

    def __init__(self, dim: int, num_heads: int, *, expand_ratio: float = 4.0,
                 layerscale_eps: float = 1e-5, backend: Optional[str] = None,
                 logits_dtype=None, attn_dropout_rate: float = 0.0,
                 dropout_rate: float = 0.0, quant: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = ClassSelfAttentionBlock(
            dim, num_heads, backend=backend, logits_dtype=logits_dtype,
            attn_dropout_rate=attn_dropout_rate, out_dropout_rate=dropout_rate, quant=quant,
        )
        self.ls1 = LayerScaleBlock(dim, layerscale_eps)
        self.norm2 = LayerNorm(dim)
        self.ff = FFBlock(dim, expand_ratio=expand_ratio, dropout_rate=dropout_rate, quant=quant)
        self.ls2 = LayerScaleBlock(dim, layerscale_eps)

    def forward(self, cls_tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        concat = torch.cat([cls_tok, tokens], dim=1)
        cls_tok = cls_tok + self.ls1(self.attn(self.norm1(concat)))
        return cls_tok + self.ls2(self.ff(self.norm2(cls_tok)))


class CaiT(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.

    ``image_size`` fixes the position table's length (the patch count; the
    trunk has no CLS token) at construction.
    """

    def __init__(
        self,
        num_classes: int,
        embed_dim: int,
        num_layers: int,
        num_layers_token_only: int,
        num_heads: int,
        patch_shape,
        *,
        image_size: int = 224,
        expand_ratio: float = 4.0,
        layerscale_eps: float = 1e-5,
        stoch_depth_rate: float = 0.0,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("CaiT", unported, _NOT_PORTED)
        self.quant = quant
        ph, pw = patch_shape
        if image_size % ph or image_size % pw:
            raise ValueError(f"image {image_size} not divisible by patch {patch_shape}")
        common = dict(expand_ratio=expand_ratio, layerscale_eps=layerscale_eps,
                      backend=backend, logits_dtype=logits_dtype,
                      attn_dropout_rate=attn_dropout_rate, dropout_rate=dropout_rate,
                      quant=quant)
        self.patch_embed = PatchEmbedBlock(patch_shape, embed_dim)
        self.pos_embed = AddAbsPosEmbed((image_size // ph) * (image_size // pw), embed_dim)
        self.pos_drop = Dropout(dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, stoch_depth_rate=stoch_depth_rate, **common)
            for _ in range(num_layers)
        )
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        # Not named after "cls": weight_decay_mask exempts any name that
        # holds it, which would take decay off the class-attention weights.
        self.ca_blocks = nn.ModuleList(
            CAEncoderBlock(embed_dim, num_heads, **common)
            for _ in range(num_layers_token_only)
        )
        self.norm = LayerNorm(embed_dim)
        self.head = dense(embed_dim, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers from an explicit generator: lecun-normal
        (truncated) kernels, zero biases, unit LayerNorm scales, orthogonal
        mixing kernels, LayerScale at its eps, normal(0.02) position table,
        zero CLS token and zero head."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, AttentionBlock):
                module.reset_parameters(generator)
            elif isinstance(module, LayerScaleBlock):
                module.reset_parameters()
            elif isinstance(module, AddAbsPosEmbed):
                module.reset_parameters(generator)
        nn.init.zeros_(self.cls)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.pos_drop(self.pos_embed(self.patch_embed(inputs)))
        for block in self.blocks:
            x = block(x)
        cls_tok = self.cls.to(x.dtype).expand(x.shape[0], 1, -1)
        for block in self.ca_blocks:
            cls_tok = block(cls_tok, x)
        return self.head(self.norm(cls_tok[:, 0]))
