"""Squeeze-and-excitation gate (port of ``sav_tpu/models/layers/squeeze_excite.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.feedforward import Dense


class SqueezeExciteBlock(nn.Module):
    """Global mean over H and W → ``reduce`` Dense (with bias) → swish →
    ``expand`` Dense (with bias) → sigmoid → per-channel gate on the input,
    in the input's dtype. ``hidden = max(1, int(ch * se_ratio))``. Takes
    ``[N, C, H, W]``."""

    def __init__(self, ch: int, se_ratio: float = 0.25):
        super().__init__()
        hidden = max(1, int(ch * se_ratio))
        self.reduce = Dense(ch, hidden)
        self.expand = Dense(hidden, ch)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        gate = inputs.mean(dim=(2, 3))
        gate = torch.sigmoid(self.expand(F.silu(self.reduce(gate))))
        return inputs * gate[:, :, None, None]
