"""Transformer MLP block (port of ``sav_tpu/models/layers/feedforward.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.regularization import Dropout


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the input's dtype: the weight and bias
    are cast at use, so f32 parameters serve bf16 activations as flax's
    ``Dense(dtype=bf16)`` does, and their gradients stay f32."""

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(inputs.dtype)
        return F.linear(inputs, self.weight.to(inputs.dtype), bias)


class FFBlock(nn.Module):
    """Dense(expand) → GELU (tanh approximation, flax's ``nn.gelu``) →
    dropout → Dense(in_ch) → dropout, in the input's dtype."""

    def __init__(
        self,
        in_ch: int,
        expand_ratio: Optional[float] = 4.0,
        hidden_ch: Optional[int] = None,
        use_bias: bool = True,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        hidden = hidden_ch or int(in_ch * expand_ratio)
        self.fc1 = Dense(in_ch, hidden, bias=use_bias)
        self.fc2 = Dense(hidden, in_ch, bias=use_bias)
        self.drop1 = Dropout(dropout_rate)
        self.drop2 = Dropout(dropout_rate)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(inputs), approximate="tanh"))
        return self.drop2(self.fc2(x))
