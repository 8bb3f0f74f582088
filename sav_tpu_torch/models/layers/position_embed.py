"""Position embeddings (port of ``sav_tpu/models/layers/position_embed.py``):
the learned absolute table, the fixed sinusoidal table and RoPE.

The fixed tables are non-persistent buffers, made in f32 for the model's
length on the module's device (:meth:`reset_buffers`), so that a captured
step reads them where they are and never copies from the host; they carry
no parameter, as ``sav_tpu``'s modules carry none. They are cast to the
activation dtype at use, so a copy cast to that dtype computes the same.
"""

from __future__ import annotations

import torch
from torch import nn

from sav_tpu_torch.ops.rotary import apply_rotary_pos_emb, fixed_positional_embedding


class AddAbsPosEmbed(nn.Module):
    """Learned table ``(1, L, D)``, normal(0.02) init, added in the input
    dtype. The length is fixed at construction (flax reads it at init)."""

    def __init__(self, length: int, dim: int, init_stddev: float = 0.02):
        super().__init__()
        self.init_stddev = init_stddev
        self.pos_embed = nn.Parameter(torch.empty(1, length, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.pos_embed, std=self.init_stddev, generator=generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return inputs + self.pos_embed.to(inputs.dtype)


class FixedPositionalEmbedding(nn.Module):
    """Adds the sinusoidal table ``[L, D]`` to ``[B, L, D]`` tokens in their
    dtype: sin on the even channels, cos on the odd ones."""

    def __init__(self, length: int, dim: int):
        super().__init__()
        self.length, self.dim = length, dim
        self.register_buffer("table", torch.empty(length, dim), persistent=False)
        if not self.table.is_meta:
            self.reset_buffers()

    def reset_buffers(self) -> None:
        sin, cos = fixed_positional_embedding(self.length, self.dim, device=self.table.device)
        even = torch.arange(self.dim, device=sin.device) % 2 == 0
        with torch.no_grad():
            self.table.copy_(torch.where(even, sin, cos))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return inputs + self.table.to(inputs.dtype)


class RotaryPositionalEmbedding(nn.Module):
    """RoPE on ``[B, L, D]`` or per-head ``[B, L, H, D]`` inputs of up to
    ``length`` positions, from ``(sin, cos)`` tables of width ``dim``; a
    shorter input takes the tables' first rows (a row depends on its
    position alone)."""

    def __init__(self, length: int, dim: int):
        super().__init__()
        self.length, self.dim = length, dim
        self.register_buffer("sin", torch.empty(length, dim), persistent=False)
        self.register_buffer("cos", torch.empty(length, dim), persistent=False)
        if not self.sin.is_meta:
            self.reset_buffers()

    def reset_buffers(self) -> None:
        sin, cos = fixed_positional_embedding(self.length, self.dim, device=self.sin.device)
        with torch.no_grad():
            self.sin.copy_(sin)
            self.cos.copy_(cos)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        length = inputs.shape[1]
        if length > self.length:
            raise ValueError(f"RoPE tables hold {self.length} positions, got {length}")
        return apply_rotary_pos_emb(inputs, (self.sin[:length], self.cos[:length]))
