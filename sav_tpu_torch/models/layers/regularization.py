"""Stochastic depth, a per-sample residual drop (port of
``sav_tpu/models/layers/regularization.py``), and dropout (flax's
``nn.Dropout``, which ``sav_tpu`` applies in its ViT and CaiT blocks).

``sav_tpu`` draws the masks from its own ``'stochastic_depth'`` and
``'dropout'`` RNG streams; here each module draws from an explicit
``torch.Generator`` on the device (:func:`set_stochastic_depth_generator`,
:func:`set_dropout_generator`), never from the global RNG. The draws cannot
match ``jax.random``'s, so tests compare at rate 0 or through
``apply_mask`` with an injected mask.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class StochasticDepthBlock(nn.Module):
    """Identity in eval mode and at rate 0; in training, each sample's branch
    is kept with probability ``1 - drop_rate`` and, with ``scale_by_keep``,
    divided by it (the mask is cast to the input dtype first, as in
    ``sav_tpu``)."""

    def __init__(self, drop_rate: float = 0.0, scale_by_keep: bool = True):
        super().__init__()
        self.drop_rate = drop_rate
        self.scale_by_keep = scale_by_keep
        self.generator: Optional[torch.Generator] = None

    def apply_mask(self, inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``inputs`` times the per-sample keep ``mask`` (bool or 0/1,
        broadcastable), scaled by ``1 / keep_prob`` when ``scale_by_keep``."""
        mask = mask.to(inputs.dtype)
        if self.scale_by_keep:
            mask = mask / (1.0 - self.drop_rate)
        return inputs * mask

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_rate == 0.0:
            return inputs
        if self.generator is None:
            raise RuntimeError(
                "stochastic depth draws its masks from an explicit generator; "
                "call set_stochastic_depth_generator(model, generator) first "
                "(the Trainer does)"
            )
        shape = (inputs.shape[0],) + (1,) * (inputs.ndim - 1)
        draw = torch.rand(shape, generator=self.generator, device=inputs.device)
        return self.apply_mask(inputs, draw < 1.0 - self.drop_rate)


def set_stochastic_depth_generator(model: nn.Module, generator: torch.Generator) -> int:
    """Give every :class:`StochasticDepthBlock` of ``model`` the generator it
    draws its masks from; returns how many there are."""
    blocks = [m for m in model.modules() if isinstance(m, StochasticDepthBlock)]
    for block in blocks:
        block.generator = generator
    return len(blocks)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: identity in eval mode and at rate 0; in
    training each element is kept with probability ``1 - rate`` and a kept
    value is divided by it (``select(mask, x / keep, 0)``), in the input
    dtype: ``keep`` is rounded to that dtype first, as JAX rounds a Python
    scalar in ``x / keep``. The mask has the input's shape."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def apply_mask(self, inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``inputs / (1 - rate)`` where ``mask`` (bool, broadcastable) is
        set, 0 elsewhere."""
        if self.rate == 1.0:
            return torch.zeros_like(inputs)
        keep = torch.tensor(1.0 - self.rate, dtype=inputs.dtype, device=inputs.device)
        return torch.where(mask, inputs / keep, torch.zeros_like(keep))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return inputs
        if self.generator is None:
            raise RuntimeError(
                "dropout draws its masks from an explicit generator; call "
                "set_dropout_generator(model, generator) first (the Trainer does)"
            )
        draw = torch.rand(inputs.shape, generator=self.generator, device=inputs.device)
        return self.apply_mask(inputs, draw < 1.0 - self.rate)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> int:
    """Give every :class:`Dropout` of ``model`` the generator it draws its
    masks from; returns how many there are."""
    layers = [m for m in model.modules() if isinstance(m, Dropout)]
    for layer in layers:
        layer.generator = generator
    return len(layers)


def module_generators(module: nn.Module) -> list:
    """The distinct generators the stochastic-depth and dropout layers of
    ``module`` draw from, in module order."""
    found = []
    for m in module.modules():
        generator = getattr(m, "generator", None) if isinstance(
            m, (Dropout, StochasticDepthBlock)) else None
        if generator is not None and all(generator is not g for g in found):
            found.append(generator)
    return found
