"""BoTNet 2-D relative-position multi-head self-attention (port of
``sav_tpu/models/layers/bot_attention.py``).

The projections keep flax ``DenseGeneral``'s ``[C, heads, head_ch]`` kernels
``to_q/to_k/to_v`` (no bias) and the relative tables their flax names and
shapes, ``rel_emb_h [2H−1, d]`` and ``rel_emb_w [2W−1, d]``, so a flax tree
converts by copying and ``weight_decay_mask`` exempts the tables by name.
The tables' sizes depend on the grid the block attends over, so the grid is
fixed at construction (the model computes it from its ``image_size``).

The core, on the port's rule
(:func:`sav_tpu_torch.ops.attention.resolve_relative_backend`): ``'pallas'``
or ``auto`` run :func:`~sav_tpu_torch.ops.flash_attention.flash_botnet_attention`
(kernels #6–#8 on CUDA, their plain versions on CPU) at every length;
``'xla'`` is the dense path, :func:`~sav_tpu_torch.ops.relative.relative_logits_2d`
plus :func:`~sav_tpu_torch.ops.attention.dense_attention` with that bias.

With ``quant`` the three projections run on the int8 arm of
:mod:`sav_tpu_torch.ops.quant`; the tables and the core stay in the compute
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.ops import quant as _quant
from sav_tpu_torch.ops.attention import dense_attention, resolve_relative_backend
from sav_tpu_torch.ops.flash_attention import flash_botnet_attention
from sav_tpu_torch.ops.relative import relative_logits_2d


class BoTMHSA(nn.Module):
    """All-2-D self-attention on an ``[N, C, H, W]`` feature map of the grid
    ``(height, width)``; returns ``[N, heads·head_ch, H, W]`` (no output
    projection: the bottleneck's 1×1 convs mix the channels). Computes in
    the input's dtype; the kernels' path reads the tables in f32, the dense
    path casts them to the input's dtype, as ``sav_tpu`` does."""

    # Tensors that stay f32 when a serving engine casts the model
    # (cast_for_compute): the kernels' path reads the tables in f32.
    F32_TENSORS = ("rel_emb_h", "rel_emb_w")

    def __init__(self, in_ch: int, num_heads: int, height: int, width: int, *,
                 head_ch: Optional[int] = None, backend: Optional[str] = None,
                 logits_dtype=None, quant: Optional[str] = None):
        super().__init__()
        self.quant = _quant.check_mode(quant)
        if quant == "int8":
            self.quant_generator = None
        self.num_heads = num_heads
        self.head_ch = head_ch or in_ch // num_heads
        self.height, self.width = height, width
        self.backend = backend
        # None = the block's compute dtype (the dense path's softmax dtype).
        self.logits_dtype = logits_dtype
        h, d = num_heads, self.head_ch
        for name in ("to_q", "to_k", "to_v"):
            _quant.declare_kernel(self, name, (in_ch, h, d), 1, quant)
        self.rel_emb_h = nn.Parameter(torch.empty(2 * height - 1, d))
        self.rel_emb_w = nn.Parameter(torch.empty(2 * width - 1, d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal projections (fan-in ``C``) and
        normal tables of std ``head_ch ** -0.5``."""
        for param in (self.to_q, self.to_k, self.to_v):
            if param.is_floating_point():  # serving codes stay 0 until quantize_params
                lecun_normal_(param, param.shape[0], generator)
        for table in (self.rel_emb_h, self.rel_emb_w):
            nn.init.normal_(table, std=self.head_ch ** -0.5, generator=generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, ch, height, width = inputs.shape
        if (height, width) != (self.height, self.width):
            raise ValueError(
                f"BoTMHSA was built for a {self.height}x{self.width} grid, got {height}x{width}"
            )
        h, d = self.num_heads, self.head_ch
        length = height * width
        dtype = inputs.dtype
        # [N, C, H, W] in channels_last memory is [N, H, W, C] contiguous:
        # the token view is a free reshape.
        tokens = inputs.permute(0, 2, 3, 1).reshape(b, length, ch)

        def proj(name):
            if self.quant:
                return _quant.project(self, name, tokens)
            w = getattr(self, name)
            return torch.matmul(tokens, w.to(dtype).reshape(ch, h * d)).view(b, length, h, d)

        query, key, value = proj("to_q"), proj("to_k"), proj("to_v")
        scale = d ** -0.5
        backend = resolve_relative_backend(height, width, d, requested=self.backend)
        if backend == "pallas":
            out = flash_botnet_attention(query, key, value, self.rel_emb_h, self.rel_emb_w,
                                         height, width, scale=scale)
        else:
            # The relative logits use the same scaled query as the content
            # logits: q scaled in its own dtype, then an f32 product.
            q_grid = query.reshape(b, height, width, h, d).permute(0, 3, 1, 2, 4)
            # A 0-dim CPU tensor: the scale rounds to q's dtype and reaches a CUDA op as
            # a scalar argument, with no host-to-device copy (legal under graph capture).
            q_grid = q_grid * torch.tensor(scale, dtype=dtype)
            bias = relative_logits_2d(q_grid, self.rel_emb_h.to(dtype), self.rel_emb_w.to(dtype))
            out = dense_attention(query, key, value, bias.reshape(b, h, length, length),
                                  scale=scale, logits_dtype=self.logits_dtype or dtype)
        return out.reshape(b, height, width, h * d).permute(0, 3, 1, 2)
