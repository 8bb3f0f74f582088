"""Transformer MLP block (port of ``sav_tpu/models/layers/feedforward.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FFBlock(nn.Module):
    """Linear(expand) → GELU (tanh approximation, flax's ``nn.gelu``) →
    Linear(in_ch). Dropout is not ported (inference slice)."""

    def __init__(
        self,
        in_ch: int,
        expand_ratio: Optional[float] = 4.0,
        hidden_ch: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        hidden = hidden_ch or int(in_ch * expand_ratio)
        self.fc1 = nn.Linear(in_ch, hidden, bias=use_bias)
        self.fc2 = nn.Linear(hidden, in_ch, bias=use_bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(inputs), approximate="tanh"))
