"""Single-query class attention (port of
``sav_tpu/models/layers/class_attention.py``): CaiT's, whose query is the
first token, and CeiT's layer-wise class attention, whose query is the
last."""

from __future__ import annotations

import torch

from sav_tpu_torch.models.layers.attention import AttentionBlock


class ClassSelfAttentionBlock(AttentionBlock):
    """The query is the first (CLS) token only; K/V span the whole sequence.
    Q comes from another tensor than K/V, so the projections are the three
    separate ``to_q/to_k/to_v`` of ``fused_qkv=False``."""

    def __init__(self, in_ch: int, num_heads: int, **kwargs):
        super().__init__(in_ch, num_heads, fused_qkv=False, **kwargs)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(inputs[:, 0:1], inputs)


class LCSelfAttentionBlock(AttentionBlock):
    """CeiT's layer-wise class attention: the query is the last token (the
    last layer's CLS token), K/V span every collected CLS token."""

    def __init__(self, in_ch: int, num_heads: int, **kwargs):
        super().__init__(in_ch, num_heads, fused_qkv=False, **kwargs)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(inputs[:, -1:], inputs)
