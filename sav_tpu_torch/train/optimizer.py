"""Schedule and masked AdamW with optax's exact semantics (port of
``sav_tpu/train/optimizer.py``).

``sav_tpu`` chains ``clip_by_global_norm → scale_by_adam →
add_decayed_weights(mask) → scale_by_learning_rate(schedule)`` and, when
asked, a parameter EMA last. :class:`AdamW` is that chain written out on
lists of tensors with ``torch._foreach_*`` ops (a few multi-tensor kernels
per step instead of several per parameter), updating parameters and moments
in place. ``optax.flatten`` changes nothing numerically and has no
counterpart.

The update count lives on the device (a 0-d int32 tensor, incremented in
place), and the schedule and the bias corrections are computed from it
there, in f32 as optax computes them: a step captured as a CUDA graph then
replays each step's own learning rate, where a value read on the host
would be baked into the graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

_NO_DECAY_NAMES = ("pos_embed", "cls", "rel_emb_h", "rel_emb_w")


def warmup_cosine_schedule(
    learning_rate: float,
    *,
    steps_per_epoch: int,
    warmup_epochs: int,
    num_epochs: int,
    end_lr: float = 1e-5,
) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` from 0 to ``learning_rate``
    over ``max(1, warmup_epochs * steps_per_epoch)`` steps, then cosine to
    ``end_lr`` at ``max(warmup + 1, num_epochs * steps_per_epoch)``: the
    update at step 0 has lr 0. The step is an int or a tensor (the
    optimizer's device count); the result is a 0-d f32 tensor on its
    device, formed in f32 with optax's operations in optax's order
    (``join_schedules`` of ``linear_schedule`` and
    ``cosine_decay_schedule``)."""
    warmup = max(1, warmup_epochs * steps_per_epoch)
    decay = max(warmup + 1, num_epochs * steps_per_epoch) - warmup
    alpha = 0.0 if learning_rate == 0.0 else end_lr / learning_rate

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        # linear_schedule(0, learning_rate, warmup): (0 - lr)·frac + lr.
        frac = 1.0 - step.clamp(0.0, warmup) / warmup
        warm = (0.0 - learning_rate) * frac + learning_rate
        # cosine_decay_schedule(learning_rate, decay, alpha) at step - warmup.
        t = torch.minimum(step - warmup, torch.full_like(step, float(decay)))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay))
        cooled = learning_rate * ((1.0 - alpha) * cosine + alpha)
        return torch.where(step < warmup, warm, cooled)

    return schedule


def weight_decay_mask(named_params) -> dict:
    """``{name: decays}``: True for rank ≥ 2 parameters whose name holds
    none of pos_embed, cls, rel_emb_h, rel_emb_w (the reference's
    weight/bias split). The stacked ``to_qkv`` (rank 4) and ``to_out``
    (rank 3) decay; biases, norm scales, the position table and CLS do not."""
    return {
        name: p.ndim >= 2 and not any(n in name for n in _NO_DECAY_NAMES)
        for name, p in named_params
    }


@dataclasses.dataclass
class OptState:
    """Adam moments (f32, one per parameter in order), the update count
    (a 0-d int32 tensor on the parameters' device, updated in place), and
    the parameter EMA when configured."""

    count: torch.Tensor
    mu: list
    nu: list
    ema: Optional[list] = None

    def state_dict(self, names: list) -> dict:
        """``{"count", "mu", "nu"[, "ema"]}`` with each list keyed by the
        parameter ``names`` (in the lists' order): plain dicts of tensors
        and an int (the count, read from the device), as a checkpoint
        stores them."""
        out = {"count": int(self.count), "mu": dict(zip(names, self.mu)),
               "nu": dict(zip(names, self.nu))}
        if self.ema is not None:
            out["ema"] = dict(zip(names, self.ema))
        return out

    def load_state_dict(self, state: dict, names: list) -> "OptState":
        """Copy ``state`` (from :meth:`state_dict`) into this state's
        tensors in place, on their devices, the count included; returns this
        state. A checkpoint with an EMA and a state without one (or the
        other way round) raise ``ValueError``: ``ema_decay`` must match the
        saved run."""
        if ("ema" in state) != (self.ema is not None):
            raise ValueError(
                f"the checkpoint {'carries' if 'ema' in state else 'lacks'} a "
                f"parameter EMA but this optimizer "
                f"{'has none' if self.ema is None else 'has one'}: set ema_decay "
                "(--ema-decay) as the checkpointed run had it"
            )
        pairs = [(self.mu, state["mu"]), (self.nu, state["nu"])]
        if self.ema is not None:
            pairs.append((self.ema, state["ema"]))
        with torch.no_grad():
            for tensors, saved in pairs:
                if set(saved) != set(names):
                    raise ValueError(
                        "the checkpoint's optimizer state names other parameters: "
                        f"missing {sorted(set(names) - set(saved))}, "
                        f"unexpected {sorted(set(saved) - set(names))}"
                    )
                for name, tensor in zip(names, tensors):
                    copy_checked(tensor, saved[name], name)
            self.count.fill_(int(state["count"]))
        return self


def copy_checked(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """``dst.copy_(src)`` (any device, any dtype) after checking the shapes."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: saved shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``: the 2-norm of all elements together, f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """Global-norm clip → Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction
    at count + 1) → decoupled weight decay on the masked parameters →
    ``-schedule(count)`` → optional parameter EMA, as ``sav_tpu``'s
    ``make_optimizer``. Nothing in :meth:`step` reads the device: it can be
    captured as part of a CUDA graph."""

    def __init__(
        self,
        schedule: Callable,
        *,
        weight_decay: float = 0.05,
        clip_grad_norm: Optional[float] = 1.0,
        ema_decay: Optional[float] = None,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        if ema_decay is not None and not 0.0 <= ema_decay <= 1.0:
            raise ValueError(f"ema decay must be in [0, 1], got {ema_decay}")
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm
        self.ema_decay = ema_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        device = params[0].device if params else None
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=zeros,
            nu=[torch.zeros_like(z) for z in zeros],
            ema=None if self.ema_decay is None else [p.detach().float().clone() for p in params],
        )

    @torch.no_grad()
    def step(self, params: list, grads: list, decay_mask: list, state: OptState, *,
             grad_norm: Optional[torch.Tensor] = None,
             lr: Optional[torch.Tensor] = None) -> OptState:
        """One update of ``params`` in place from ``grads`` (pre-clip, with
        their :func:`global_norm` if the caller has it, and the learning
        rate ``schedule(state.count)`` if it has that); ``decay_mask`` holds
        one bool per parameter. The moments, the EMA and the count are
        updated in place; returns ``state``."""
        grads = [g.float() for g in grads]
        if self.clip_grad_norm is not None:
            # optax.clip_by_global_norm: g · max/‖g‖ only when ‖g‖ ≥ max.
            norm = global_norm(grads) if grad_norm is None else grad_norm
            factor = torch.where(norm < self.clip_grad_norm, 1.0, self.clip_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        # optax's scale_by_learning_rate reads the count before the
        # increment, its bias corrections the count after it: f32 on the
        # device, as optax forms them.
        if lr is None:
            lr = self.schedule(state.count)
        state.count.add_(1)
        count = state.count.to(torch.float32)
        denom = torch._foreach_div(state.nu, 1.0 - torch.pow(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, 1.0 - torch.pow(b1, count))
        torch._foreach_div_(updates, denom)
        decayed = [i for i, m in enumerate(decay_mask) if m]
        if decayed and self.weight_decay:
            torch._foreach_add_(
                [updates[i] for i in decayed],
                [params[i].float() for i in decayed],
                alpha=self.weight_decay,
            )
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(updates, params)])
        ema = state.ema
        if ema is not None:
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, [p.float() for p in params], alpha=1.0 - self.ema_decay)
        return state


def make_optimizer(
    schedule: Callable,
    *,
    weight_decay: float = 0.05,
    clip_grad_norm: Optional[float] = 1.0,
    ema_decay: Optional[float] = None,
) -> AdamW:
    """The masked AdamW of ``sav_tpu.train.optimizer.make_optimizer``."""
    return AdamW(
        schedule,
        weight_decay=weight_decay,
        clip_grad_norm=clip_grad_norm,
        ema_decay=ema_decay,
    )
