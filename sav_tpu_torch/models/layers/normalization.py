"""LayerScale (port of ``sav_tpu/models/layers/normalization.py``)."""

from __future__ import annotations

import torch
from torch import nn


class LayerScaleBlock(nn.Module):
    """Per-channel learned scale on a residual branch, initialised to
    ``eps`` and cast to the input's dtype at use."""

    def __init__(self, dim: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.scale, self.eps)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return inputs * self.scale.to(inputs.dtype)
