"""Train state (port of ``sav_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses

from torch import nn

from sav_tpu_torch.train.optimizer import OptState


@dataclasses.dataclass
class TrainState:
    """Step count, the model (whose parameters are the state's parameters),
    the optimizer state, and ``batch_stats``: the model's buffers by name,
    the BatchNorm running statistics (empty for ViT and CaiT).

    ``sav_tpu``'s state is an immutable pytree; here the model and the
    optimizer state are updated in place by each step, and the step count
    is a host integer, so reading it never waits on the device. The
    ``batch_stats`` tensors are the model's own buffers, updated in place by
    each train step."""

    step: int
    model: nn.Module
    opt_state: OptState
    batch_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())
