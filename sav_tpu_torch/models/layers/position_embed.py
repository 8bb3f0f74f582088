"""Learned absolute position embedding (port of
``sav_tpu/models/layers/position_embed.py``)."""

from __future__ import annotations

import torch
from torch import nn


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
