"""Multi-head attention blocks (port of ``sav_tpu/models/layers/attention.py``).

Self-attention keeps ``_FusedQKVProj``'s stacked flax shape ``[in, 3, H, D]``;
cross-attention (``fused_qkv=False``: Q from another input than K/V, as in
class attention) keeps ``DenseGeneral``'s three ``[in, H, D]`` kernels
``to_q/to_k/to_v``; the output merge keeps ``[H, D, out]``. So a flax tree
converts by copying (``sav_tpu_torch.interop``). Each projection is one
matmul against a slice of the parameter, which keeps q, k and v in their
natural ``[B, L, H, D]`` layout, the layout the kernels read.

With ``talking_heads=True`` (CaiT's trunk) the core mixes the logits and the
probabilities across heads through two ``[H, H]`` kernels
(``pre_softmax``/``post_softmax``), on the port's rule
(:func:`sav_tpu_torch.ops.talking_heads.resolve_talking_heads_backend`): the
talking-heads kernels, or the dense path for ``backend='xla'``. Otherwise
the core is the seam of :mod:`sav_tpu_torch.ops.attention`.

With ``quant`` (``"int8"``, QAT, or ``"int8_serve"``) the projections run
on the int8 arm of :mod:`sav_tpu_torch.ops.quant` (the attention core stays
in the compute dtype): the stacked QKV as one product whose output is the
three contiguous ``[M, H·D]`` slices, the others one product each. Serving,
each projection is int8 codes of the parameter's shape with an f32
``<name>_scale`` beside it.

``attn_dropout_rate`` drops attention probabilities in training, on the
dense path only (``auto`` takes it; a kernel backend raises), and
``out_dropout_rate`` the merged output, as ``sav_tpu``'s blocks do.

With ``use_rotary=True`` q and k are rotated (RoPE) after the projections
and before the core, each at its own length, in their ``[B, L, H, D]``
layout; the tables are buffers made for ``rotary_length`` positions (the
model's length).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.layers.position_embed import RotaryPositionalEmbedding
from sav_tpu_torch.models.layers.regularization import Dropout
from sav_tpu_torch.ops import quant as _quant
from sav_tpu_torch.ops import talking_heads as _th
from sav_tpu_torch.ops.attention import dot_product_attention


class TalkingHeadsBlock(nn.Module):
    """The learned ``[H, H]`` head-mixing kernel (orthogonal init);
    ``mixed_i = Σ_h kernel[h, i] · head_h``. The attention core reads it
    uncast: the mixes run in f32 whatever the activations' dtype."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_heads, num_heads))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.orthogonal_(self.kernel, generator=generator)


class AttentionBlock(nn.Module):
    """Multi-head (cross-)attention with optional talking heads, no biases;
    logits scale ``head_ch ** -0.5``."""

    def __init__(
        self,
        in_ch: int,
        num_heads: int,
        *,
        head_ch: Optional[int] = None,
        out_ch: Optional[int] = None,
        talking_heads: bool = False,
        fused_qkv: bool = True,
        use_rotary: bool = False,
        rotary_length: Optional[int] = None,
        backend: Optional[str] = None,
        logits_dtype=None,
        attn_dropout_rate: float = 0.0,
        out_dropout_rate: float = 0.0,
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_ch = head_ch or in_ch // num_heads
        self.talking_heads = talking_heads
        self.fused_qkv = fused_qkv
        self.quant = _quant.check_mode(quant)
        if quant == "int8":
            self.quant_generator = None
        self.backend = backend
        # None = the block's compute dtype, resolved per call (sav_tpu's
        # rule); the talking-heads core always mixes in f32.
        self.logits_dtype = logits_dtype
        h, d = num_heads, self.head_ch
        if fused_qkv:
            _quant.declare_kernel(self, "to_qkv", (in_ch, 3, h, d), 1, quant)
        else:
            for name in ("to_q", "to_k", "to_v"):
                _quant.declare_kernel(self, name, (in_ch, h, d), 1, quant)
        if talking_heads:
            self.pre_softmax = TalkingHeadsBlock(h)
            self.post_softmax = TalkingHeadsBlock(h)
        _quant.declare_kernel(self, "to_out", (h, d, out_ch or in_ch), 2, quant)
        self.rotary = RotaryPositionalEmbedding(rotary_length, d) if use_rotary else None
        self.attn_drop = Dropout(attn_dropout_rate)
        self.out_drop = Dropout(out_dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal projections (fan-in ``in_ch``,
        and ``H·D`` for the merge) and orthogonal mixing kernels. Serving,
        the int8 codes are left to
        :func:`~sav_tpu_torch.ops.quant.init_serving` and
        :func:`~sav_tpu_torch.ops.quant.quantize_params`."""
        if self.quant == "int8_serve":
            if self.talking_heads:
                self.pre_softmax.reset_parameters(generator)
                self.post_softmax.reset_parameters(generator)
            return
        if self.fused_qkv:
            lecun_normal_(self.to_qkv, self.to_qkv.shape[0], generator)
        else:
            for param in (self.to_q, self.to_k, self.to_v):
                lecun_normal_(param, param.shape[0], generator)
        if self.talking_heads:
            self.pre_softmax.reset_parameters(generator)
            self.post_softmax.reset_parameters(generator)
        h, d, _ = self.to_out.shape
        lecun_normal_(self.to_out, h * d, generator)

    def _core(self, query, key, value):
        scale = self.head_ch ** -0.5
        dropout = self.attn_drop if self.attn_drop.active() else None
        if not self.talking_heads:
            return dot_product_attention(
                query, key, value,
                scale=scale,
                backend=self.backend,
                logits_dtype=self.logits_dtype or query.dtype,
                dropout=dropout,
            )
        w_pre, w_post = self.pre_softmax.kernel, self.post_softmax.kernel
        backend = _th.resolve_talking_heads_backend(
            self.num_heads, key.shape[1], self.head_ch,
            dtype=query.dtype, requested=self.backend, dropout=dropout is not None,
        )
        if backend == "fused":
            return _th.flash_talking_heads_attention(
                query, key, value, w_pre, w_post, scale=scale
            )
        return _th.dense_talking_heads(query, key, value, w_pre, w_post, scale=scale,
                                       dropout=dropout)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor) -> torch.Tensor:
        b, q_len, in_ch = inputs_q.shape
        kv_len = inputs_kv.shape[1]
        h, d = self.num_heads, self.head_ch
        dtype = inputs_q.dtype

        def proj(inputs, w, length):
            return torch.matmul(inputs, w.reshape(in_ch, h * d)).view(b, length, h, d)

        if self.fused_qkv and inputs_q is not inputs_kv:
            raise ValueError(
                "fused_qkv=True projects Q, K and V from one input and is "
                "only valid for self-attention; pass fused_qkv=False for "
                "cross-attention"
            )
        if self.quant and self.fused_qkv:
            qkv = _quant.project_qkv(self, inputs_q.reshape(b * q_len, in_ch))
            query, key, value = (t.view(b, q_len, h, d) for t in qkv.unbind(0))
        elif self.quant:
            query = _quant.project(self, "to_q", inputs_q)
            key = _quant.project(self, "to_k", inputs_kv)
            value = _quant.project(self, "to_v", inputs_kv)
        elif self.fused_qkv:
            w = self.to_qkv.to(dtype)
            query, key, value = (proj(inputs_q, w[:, t], q_len) for t in range(3))
        else:
            query = proj(inputs_q, self.to_q.to(dtype), q_len)
            key = proj(inputs_kv, self.to_k.to(dtype), kv_len)
            value = proj(inputs_kv, self.to_v.to(dtype), kv_len)
        if self.rotary is not None:
            query, key = self.rotary(query), self.rotary(key)
        out = self._core(query, key, value)
        if self.quant:
            return self.out_drop(_quant.project(self, "to_out", out, 2))
        w_out = self.to_out.to(out.dtype).reshape(h * d, -1)
        return self.out_drop(torch.matmul(out.reshape(b, q_len, h * d), w_out))


class SelfAttentionBlock(AttentionBlock):
    """Self-attention specialisation."""

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(inputs, inputs)
