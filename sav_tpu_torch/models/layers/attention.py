"""Multi-head self-attention blocks (port of the dense self-attention branch
of ``sav_tpu/models/layers/attention.py``).

The QKV parameter keeps ``_FusedQKVProj``'s stacked flax shape
``[in, 3, H, D]`` and the output merge keeps ``DenseGeneral``'s
``[H, D, out]``, so a flax tree converts by copying (``sav_tpu_torch.interop``).
Each projection is one matmul against a slice of the parameter, which keeps
q, k and v in their natural ``[B, L, H, D]`` layout, the layout the fused
kernel reads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.ops.attention import dot_product_attention


class AttentionBlock(nn.Module):
    """Multi-head attention with the stacked QKV projection, no biases;
    logits scale ``head_ch ** -0.5``. Self-attention only in this port:
    cross-attention (``fused_qkv=False`` in ``sav_tpu``) comes with the
    families that use it."""

    def __init__(
        self,
        in_ch: int,
        num_heads: int,
        *,
        head_ch: Optional[int] = None,
        out_ch: Optional[int] = None,
        backend: Optional[str] = None,
        logits_dtype=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_ch = head_ch or in_ch // num_heads
        self.backend = backend
        # None = the block's compute dtype, resolved per call (sav_tpu's rule).
        self.logits_dtype = logits_dtype
        self.to_qkv = nn.Parameter(torch.empty(in_ch, 3, num_heads, self.head_ch))
        self.to_out = nn.Parameter(torch.empty(num_heads, self.head_ch, out_ch or in_ch))

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor) -> torch.Tensor:
        if inputs_q is not inputs_kv:
            raise NotImplementedError(
                "cross-attention (separate to_q/to_k/to_v projections) is not "
                "ported yet; it comes with CaiT and CvT (ROADMAP queue A7)"
            )
        b, length, in_ch = inputs_q.shape
        h, d = self.num_heads, self.head_ch
        w = self.to_qkv.to(inputs_q.dtype)

        def proj(t):
            return torch.matmul(inputs_q, w[:, t].reshape(in_ch, h * d)).view(b, length, h, d)

        out = dot_product_attention(
            proj(0), proj(1), proj(2),
            scale=d ** -0.5,
            backend=self.backend,
            logits_dtype=self.logits_dtype or inputs_q.dtype,
        )
        w_out = self.to_out.to(out.dtype).reshape(h * d, -1)
        return torch.matmul(out.reshape(b, length, h * d), w_out)


class SelfAttentionBlock(AttentionBlock):
    """Self-attention specialisation."""

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(inputs, inputs)
