"""CvT's conv-projection attention (port of
``sav_tpu/models/layers/cvt_attention.py``).

Q, K and V each come from a depthwise 3×3 conv and a BatchNorm on the token
grid, then a pointwise projection to ``[heads, head_ch]``; K and V are
strided 2× (``strides=(1, 2, 2)``), so the attention core sees ``q_len ≠
kv_len``: at CvT-13's 224² stage 1 3,136 queries over 784 keys, stage 2
784 over 196, stage 3 197 over 50 (the CLS token skips the conv and joins
each projection). The core is the backend-dispatched seam of
:mod:`sav_tpu_torch.ops.attention` (the fused or flash kernels under
``auto``); with ``talking_heads=True`` it is the dense talking-heads path,
as ``sav_tpu`` runs it (its XLA ``talking_heads_attention``). Attention
dropout takes the dense path, as everywhere in the port.

Parameters keep flax's shapes: ``pointwise`` ``[C, H, D]`` (a
``DenseGeneral`` to ``(heads, head_ch)``) and ``to_out`` ``[H, D, out]``
(a ``DenseGeneral`` contracting ``(-2, -1)``), so a flax tree converts by
copying.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.layers.attention import TalkingHeadsBlock
from sav_tpu_torch.models.layers.depthwise import DepthwiseConv2D
from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.layers.normalization import BatchNorm
from sav_tpu_torch.models.layers.regularization import Dropout
from sav_tpu_torch.ops import quant as _quant
from sav_tpu_torch.ops import talking_heads as _th
from sav_tpu_torch.ops.attention import dot_product_attention


class ConvProjectionBlock(nn.Module):
    """Tokens ``[B, (1 +) h·w, C]`` → head-split ``[B, L', heads, head_ch]``:
    depthwise conv (``stride``) and BatchNorm on the ``h × w`` grid, the CLS
    token (``with_cls``) joined back after them, then the pointwise
    projection, without bias."""

    def __init__(self, in_ch: int, num_heads: int, head_ch: int, *, kernel_size=(3, 3),
                 stride: int = 1, with_cls: bool = False, quant: Optional[str] = None):
        super().__init__()
        self.with_cls = with_cls
        self.quant = _quant.check_mode(quant)
        if quant == "int8":
            self.quant_generator = None
        self.depthwise = DepthwiseConv2D(in_ch, kernel_size, stride)
        self.bn = BatchNorm(in_ch)
        _quant.declare_kernel(self, "pointwise", (in_ch, num_heads, head_ch), 1, quant)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The pointwise projection, lecun-normal over the fan-in ``C`` (the
        conv and the BatchNorm reset themselves); serving codes stay 0."""
        if self.pointwise.is_floating_point():
            lecun_normal_(self.pointwise, self.pointwise.shape[0], generator)

    def forward(self, tokens: torch.Tensor, grid_shape) -> torch.Tensor:
        b, _, ch = tokens.shape
        h, w = grid_shape
        cls_tok, grid = (tokens[:, :1], tokens[:, 1:]) if self.with_cls else (None, tokens)
        x = self.depthwise(grid.reshape(b, h, w, ch))
        x = self.bn(x.reshape(-1, ch)).view(b, -1, ch)
        if cls_tok is not None:
            x = torch.cat([cls_tok, x], dim=1)
        _, heads, head_ch = self.pointwise.shape
        if self.quant:
            return _quant.project(self, "pointwise", x)
        out = torch.matmul(x, self.pointwise.to(x.dtype).reshape(ch, heads * head_ch))
        return out.view(b, -1, heads, head_ch)


class CvTAttentionBlock(nn.Module):
    """Attention over a token grid with conv Q/K/V projections (strides
    ``(q, k, v)``), logits scale ``head_ch ** -0.5``, and the output merge
    ``to_out`` over heads and head dim, without biases."""

    def __init__(
        self,
        in_ch: int,
        num_heads: int,
        *,
        head_ch: Optional[int] = None,
        out_ch: Optional[int] = None,
        strides=(1, 2, 2),
        talking_heads: bool = False,
        with_cls: bool = False,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        out_dropout_rate: float = 0.0,
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.quant = _quant.check_mode(quant)
        if quant == "int8":
            self.quant_generator = None
        self.num_heads = num_heads
        self.head_ch = head_ch or in_ch // num_heads
        self.talking_heads = talking_heads
        self.backend = backend
        # None = the block's compute dtype, resolved per call.
        self.logits_dtype = logits_dtype
        h, d = num_heads, self.head_ch
        sq, sk, sv = strides
        self.to_q = ConvProjectionBlock(in_ch, h, d, stride=sq, with_cls=with_cls, quant=quant)
        self.to_k = ConvProjectionBlock(in_ch, h, d, stride=sk, with_cls=with_cls, quant=quant)
        self.to_v = ConvProjectionBlock(in_ch, h, d, stride=sv, with_cls=with_cls, quant=quant)
        if talking_heads:
            self.pre_softmax = TalkingHeadsBlock(h)
            self.post_softmax = TalkingHeadsBlock(h)
        _quant.declare_kernel(self, "to_out", (h, d, out_ch or in_ch), 2, quant)
        self.attn_drop = Dropout(attn_dropout_rate)
        self.out_drop = Dropout(out_dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers of the block's own parameters: orthogonal
        mixing kernels and a lecun-normal merge over the fan-in ``H·D``
        (the projections reset themselves)."""
        if self.talking_heads:
            self.pre_softmax.reset_parameters(generator)
            self.post_softmax.reset_parameters(generator)
        h, d, _ = self.to_out.shape
        if self.to_out.is_floating_point():  # serving codes stay 0
            lecun_normal_(self.to_out, h * d, generator)

    def forward(self, inputs: torch.Tensor, grid_shape) -> torch.Tensor:
        query = self.to_q(inputs, grid_shape)
        key = self.to_k(inputs, grid_shape)
        value = self.to_v(inputs, grid_shape)
        scale = self.head_ch ** -0.5
        dropout = self.attn_drop if self.attn_drop.active() else None
        if self.talking_heads:
            out = _th.dense_talking_heads(query, key, value, self.pre_softmax.kernel,
                                          self.post_softmax.kernel, scale=scale, dropout=dropout)
        else:
            out = dot_product_attention(
                query, key, value,
                scale=scale,
                backend=self.backend,
                logits_dtype=self.logits_dtype or query.dtype,
                dropout=dropout,
            )
        b, q_len, h, d = out.shape
        if self.quant:
            return self.out_drop(_quant.project(self, "to_out", out, 2))
        w_out = self.to_out.to(out.dtype).reshape(h * d, -1)
        return self.out_drop(torch.matmul(out.reshape(b, q_len, h * d), w_out))


class CvTSelfAttentionBlock(CvTAttentionBlock):
    """The name ``sav_tpu``'s CvT builds (the block already attends over its
    own token grid)."""
