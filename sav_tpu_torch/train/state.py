"""Train state (port of ``sav_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
import logging

import torch
from torch import nn

from sav_tpu_torch.train.optimizer import OptState, copy_checked


def persistent_buffers(model: nn.Module) -> dict:
    """``model``'s buffers by name that its ``state_dict`` holds: the
    BatchNorm running statistics, not the fixed position tables, which are
    made at construction and never change."""
    kept = set(model.state_dict(keep_vars=True))
    return {name: buf for name, buf in model.named_buffers() if name in kept}


# Generators a checkpoint may lack: added after checkpoints were first
# written (device_preprocess's mixes), or a float run's checkpoint restored
# into a QAT trainer (the int8 arm's stochastic rounding).
OPTIONAL_GENERATORS = ("mix", "quant")


@dataclasses.dataclass
class TrainState:
    """Step count, the model (whose parameters are the state's parameters),
    the optimizer state, ``batch_stats``: the model's persistent buffers by
    name, the BatchNorm running statistics (empty for ViT and CaiT), and
    ``generators``: the trainer's generators by stream name
    (``stochastic_depth``, ``dropout``, ``mix``), whose states resume the
    masks and the mixes' draws.

    ``sav_tpu``'s state is an immutable pytree; here the model and the
    optimizer state are updated in place by each step, and the step count
    is a host integer, so reading it never waits on the device (the
    optimizer keeps its own count on the device). The ``batch_stats``
    tensors are the model's own buffers, updated in place by each train
    step."""

    step: int
    model: nn.Module
    opt_state: OptState
    batch_stats: dict = dataclasses.field(default_factory=dict)
    generators: dict = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        """The state as plain dicts of tensors, ints and strings:
        ``{"step", "params", "batch_stats", "opt_state", "generators"}``
        (the generators' ``get_state()`` byte tensors). The tensors are the
        live ones, not copies."""
        params = self.params
        return {
            "step": int(self.step),
            "params": params,
            "batch_stats": dict(self.batch_stats),
            "opt_state": self.opt_state.state_dict(list(params)),
            "generators": {name: g.get_state() for name, g in self.generators.items()},
        }

    def load_state_dict(self, state: dict) -> "TrainState":
        """Copy ``state`` (from :meth:`state_dict`, any device) into this
        state's tensors and generators in place; returns the state at the
        saved step. Names and shapes must match (``ValueError``). A
        checkpoint written before the ``mix`` generator existed restores
        without it: that generator keeps its state (the trainer's fresh one
        from the seed), with a warning."""
        params = self.params
        with torch.no_grad():
            for kind, live in (("params", params), ("batch_stats", self.batch_stats)):
                saved = state[kind]
                if set(saved) != set(live):
                    raise ValueError(
                        f"the checkpoint's {kind} do not match the model's: missing "
                        f"{sorted(set(live) - set(saved))}, unexpected "
                        f"{sorted(set(saved) - set(live))}"
                    )
                for name, tensor in live.items():
                    copy_checked(tensor, saved[name], name)
        opt_state = self.opt_state.load_state_dict(state["opt_state"], list(params))
        saved = state.get("generators", {})
        for name, generator in self.generators.items():
            if name not in saved:
                if name in OPTIONAL_GENERATORS:
                    logging.warning("the checkpoint holds no state of the %r generator; it "
                                    "keeps its fresh state", name)
                    continue
                raise ValueError(f"the checkpoint holds no state of the {name!r} generator")
            generator.set_state(saved[name])
        return dataclasses.replace(self, step=int(state["step"]), opt_state=opt_state)
