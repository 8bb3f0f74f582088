"""Stochastic depth, a per-sample residual drop (port of
``sav_tpu/models/layers/regularization.py``), and dropout (flax's
``nn.Dropout``, which ``sav_tpu`` applies in its ViT and CaiT blocks).

``sav_tpu`` draws the masks from its own ``'stochastic_depth'`` and
``'dropout'`` RNG streams; here each module draws from an explicit
``torch.Generator`` on the device (:func:`set_stochastic_depth_generator`,
:func:`set_dropout_generator`), never from the global RNG. The draws cannot
match ``jax.random``'s, so tests compare at rate 0 or through
``apply_mask`` with an injected mask. A recomputed block draws its masks
again from twins of those generators (:class:`RecomputeGenerators`, see
``models/vit.py::remat_block``).
"""

from __future__ import annotations

import functools
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
        keep = _keep_scale(1.0 - self.rate, inputs.dtype, inputs.device)
        return torch.where(mask, inputs / keep, torch.zeros_like(keep))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return inputs
        if self.generator is None:
            raise RuntimeError(
                "dropout draws its masks from an explicit generator; call "
                "set_dropout_generator(model, generator) first (the Trainer does)"
            )
        # The f32 draw (4 bytes an element) is freed before the mask is
        # applied, so it adds nothing to the peak of what apply_mask makes.
        mask = torch.rand(inputs.shape, generator=self.generator, device=inputs.device) < (
            1.0 - self.rate)
        return self.apply_mask(inputs, mask)


@functools.cache
def _keep_scale(keep: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``keep`` as a 0-d tensor of ``dtype`` on ``device``, made once: a
    train step captured as a CUDA graph cannot hold the host-to-device copy
    that making it on every call would be."""
    return torch.tensor(keep, dtype=dtype, device=device)


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


class RecomputeGenerators:
    """The generators that recomputed blocks draw their masks from again.

    A block recomputed in the backward (``models/vit.py::remat_block``)
    must draw the masks its forward drew. Rewinding its layers' generators
    for that takes ``Generator.set_state``, which a CUDA graph capture
    refuses, and keeping the forward's masks until the backward costs a
    byte an element. So every forward of a recomputed block in a step gets
    twins of the generators its layers draw from (:meth:`twins`), standing
    where those stood when the forward began, and its recompute draws from
    the twins:

    - run eagerly, each twin is set to its generator's state there, and on
      the card the generator's offset from the step's start
      (:meth:`begin_step`) is recorded;
    - in a captured step the twins are registered with the graph
      (:meth:`generators`: a replay reads a registered generator's offset
      when it is launched), and before each replay :meth:`position` puts
      each twin at its generator's offset plus the recorded one: where the
      replayed forward draws.

    The twins are made by eager steps (the warm-ups before a capture); a
    capture that finds none for a forward raises."""

    def __init__(self):
        # Per forward of a recomputed block in a step: (generator, twin)
        # pairs, and each generator's offset there from the step's start.
        self._pairs: list = []
        self._offsets: list = []
        self._start: list = []
        self._next = 0

    def begin_step(self, generators) -> None:
        """Start a step whose layers draw from ``generators``."""
        self._next = 0
        if not _capturing():
            self._start = [(g, g.get_offset()) for g in generators if g.device.type == "cuda"]

    def twins(self, generators: list) -> list:
        """At the forward of a recomputed block, before it draws: a twin of
        each of ``generators`` standing where that generator stands."""
        capturing = _capturing()
        k = self._next
        self._next += 1
        if k == len(self._pairs) or not _same(generators, [g for g, _ in self._pairs[k]]):
            if capturing:
                raise RuntimeError("a recomputed block has no twin generators made for it: "
                                   "run the step eagerly before capturing it")
            del self._pairs[k:], self._offsets[k:]
            self._pairs.append([(g, torch.Generator(device=g.device)) for g in generators])
            self._offsets.append([0] * len(generators))
        pairs = self._pairs[k]
        if not capturing:
            for i, (g, twin) in enumerate(pairs):
                twin.set_state(g.get_state())
                if g.device.type == "cuda":
                    start = next(o for s, o in self._start if s is g)
                    self._offsets[k][i] = g.get_offset() - start
        return [twin for _, twin in pairs]

    def generators(self) -> list:
        """Every twin, to register with a graph."""
        return [twin for pairs in self._pairs for _, twin in pairs]

    def offsets(self) -> list:
        """The offsets the last eager step recorded, for :meth:`position`."""
        return [list(o) for o in self._offsets]

    def position(self, offsets: list) -> None:
        """Before a replay of a step whose eager run recorded ``offsets``:
        each twin at its generator's offset plus the recorded one."""
        for pairs, offs in zip(self._pairs, offsets):
            for (g, twin), off in zip(pairs, offs):
                twin.set_state(g.get_state())
                twin.set_offset(g.get_offset() + off)


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def set_recompute_generators(model: nn.Module, recompute: RecomputeGenerators) -> int:
    """Give every block of ``model`` that remat may recompute (a module
    with a ``recompute_generators`` attribute) the twins' keeper; returns
    how many there are."""
    found = [m for m in model.modules() if hasattr(m, "recompute_generators")]
    for m in found:
        m.recompute_generators = recompute
    return len(found)
