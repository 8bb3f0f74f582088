"""MLP-Mixer (port of ``sav_tpu/models/mlp_mixer.py``).

Patch embedding, then blocks of a token-mixing MLP (an :class:`FFBlock`
across the token axis: the LayerNorm'd tokens transposed to ``[B, D, L]``)
and a channel-mixing MLP, each pre-LN with a residual; a final LayerNorm, a
mean over the tokens and a zero-init head. No attention: the family runs no
attention kernel of :mod:`sav_tpu_torch.ops`; with ``quant`` both MLPs and
the head run on the int8 arm (:mod:`sav_tpu_torch.ops.quant`, the token
MLP contracting K = 196 at 224²). Inputs are NHWC, as in ``sav_tpu``;
parameters stay in their own dtype and every layer computes in its input's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.ceit import reset_conv_model
from sav_tpu_torch.models.layers import FFBlock, PatchEmbedBlock, dense
from sav_tpu_torch.models.vit import LayerNorm, refuse_unported

# sav_tpu MLP-Mixer options this port does not carry yet (none); any other
# name raises TypeError.
_NOT_PORTED: dict = {}


def mean_tokens(x: torch.Tensor) -> torch.Tensor:
    """``[B, L, D]`` → ``[B, D]``, the mean over the tokens as ``jnp.mean``
    takes it: summed in f32 and cast back to ``x``'s dtype."""
    return x.float().mean(dim=1).to(x.dtype)


class MixerBlock(nn.Module):
    """LN → token-mixing FF on ``[B, D, L]`` → residual; LN → channel-mixing
    FF → residual. The token-mixing MLP reads the transposed view as it
    stands (a non-contiguous ``[B, D, L]``: ``F.linear`` contracts its last
    axis, L)."""

    def __init__(self, num_tokens: int, dim: int, tokens_hidden_ch: int,
                 channels_hidden_ch: int, *, dropout_rate: float = 0.0,
                 quant: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.token_mixing = FFBlock(num_tokens, hidden_ch=tokens_hidden_ch,
                                    dropout_rate=dropout_rate, quant=quant)
        self.norm2 = LayerNorm(dim)
        self.channel_mixing = FFBlock(dim, hidden_ch=channels_hidden_ch,
                                      dropout_rate=dropout_rate, quant=quant)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.token_mixing(self.norm1(inputs).transpose(1, 2)).transpose(1, 2) + inputs
        return x + self.channel_mixing(self.norm2(x))


class MLPMixer(nn.Module):
    """inputs ``[B, H, W, C]`` NHWC → logits ``[B, num_classes]``.

    ``image_size`` fixes the token count, the token-mixing MLP's width, at
    construction (flax reads it from the init input)."""

    def __init__(
        self,
        num_classes: int,
        embed_dim: int,
        num_layers: int,
        tokens_hidden_ch: int,
        channels_hidden_ch: int,
        patch_shape,
        *,
        image_size: int = 224,
        dropout_rate: float = 0.0,
        quant: Optional[str] = None,
        **unported,
    ):
        super().__init__()
        refuse_unported("MLPMixer", unported, _NOT_PORTED)
        self.quant = quant
        ph, pw = patch_shape
        if image_size % ph or image_size % pw:
            raise ValueError(f"image {image_size} not divisible by patch {patch_shape}")
        self.image_size = image_size
        num_tokens = (image_size // ph) * (image_size // pw)
        self.patch_embed = PatchEmbedBlock(patch_shape, embed_dim)
        self.blocks = nn.ModuleList(
            MixerBlock(num_tokens, embed_dim, tokens_hidden_ch, channels_hidden_ch,
                       dropout_rate=dropout_rate, quant=quant)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(embed_dim)
        self.head = dense(embed_dim, num_classes, quant=quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_conv_model(self, generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(inputs)
        for block in self.blocks:
            x = block(x)
        return self.head(mean_tokens(self.norm(x)))
