"""flax's initialisers drawn from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(param: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``variance_scaling(1.0, "fan_in", "truncated_normal")``: the
    stddev is corrected for the truncation at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(param, std=std, a=-2 * std, b=2 * std, generator=generator)
