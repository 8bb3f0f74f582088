"""Mixture-of-experts feed-forward (port of ``sav_tpu/models/layers/moe.py``).

Token-choice top-k routing with a per-group capacity, each batch row a
group, as ``sav_tpu``'s ``MoEFFBlock``: an f32 router, softmax, the top
``k`` experts of each token (ties to the lower index) with their gates
renormalised to sum to 1, and each expert's buffer of
``max(k, ceil(capacity_factor·k·S/E))`` slots filled slot-major (every
token's first choice before any second choice, in token order inside a
choice); a token past its expert's capacity falls through the residual.

``sav_tpu`` dispatches and combines by dense one-hot einsums. Here both go
by index, with no host sync and no shape that depends on the data (a
captured step replays them): each (token, choice) gets its flat slot
``expert·C + position``, or a spare slot past the experts' buffers when
dropped. Dispatch writes each token into its slots (``scatter``; the
slots are unique but for the spare one, which is cut off), so its backward
is a gather; combine gathers each choice's expert output and sums the
choices weighted by the gates, rounded to the compute dtype first as
``combine.astype(cdt)`` rounds them. Neither backward adds two values into
one place, so two backward runs are bit-equal.

In training the block computes the Switch balance loss ``E · Σ f_e·P_e``
(``f_e`` the share of top-1 choices, ``P_e`` the mean router probability)
and, when its weight is not 0, the router z-loss ``weight ·
mean(logsumexp²)``, and appends them to :attr:`MoEFFBlock.sink` when one is
set (:func:`sow_losses`): ``sav_tpu``'s ``self.sow("losses", ...)``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.layers.initializers import lecun_normal_
from sav_tpu_torch.models.layers.regularization import Dropout


def route(logits: torch.Tensor, top_k: int, capacity_: int) -> tuple:
    """``(probs, gates, experts, slots)`` of f32 router ``logits [G, S, E]``:
    their softmax, then :func:`assign`."""
    probs = torch.softmax(logits, dim=-1)
    return (probs, *assign(probs, top_k, capacity_))


def assign(probs: torch.Tensor, top_k: int, capacity_: int) -> tuple:
    """``(gates, experts, slots)`` of router probabilities ``[G, S, E]``:
    the top-``top_k`` gates renormalised to sum to 1 ``[G, S, k]`` (0 where
    the choice was dropped), their experts ``[G, S, k]`` (ties to the lower
    index: a stable descending sort) and each choice's flat slot
    ``expert·C + position`` in ``[0, E·C)``, or ``E·C`` where the expert's
    ``capacity_`` slots were full."""
    g, s, n_exp = probs.shape
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, experts = top[..., :top_k], experts[..., :top_k]
    gates = top / top.sum(dim=-1, keepdim=True)
    expert_ids = torch.arange(n_exp, device=probs.device)
    counts = torch.zeros(g, 1, n_exp, dtype=torch.int64, device=probs.device)
    slots, kept = [], []
    for choice in range(top_k):  # slot-major: all first choices, then all second ...
        onehot = (experts[..., choice, None] == expert_ids).long()  # [G, S, E]
        position = ((onehot.cumsum(dim=1) - 1 + counts) * onehot).sum(dim=-1)  # [G, S]
        keep = position < capacity_
        slots.append(torch.where(keep, experts[..., choice] * capacity_ + position,
                                 n_exp * capacity_))
        kept.append(keep)
        counts = counts + onehot.sum(dim=1, keepdim=True)
    kept = torch.stack(kept, dim=-1)
    return gates * kept, experts, torch.stack(slots, dim=-1)


class MoEFFBlock(nn.Module):
    """Routed transformer MLP on ``[B, L, D]`` tokens, a drop-in for
    :class:`~sav_tpu_torch.models.layers.FFBlock`: the router ``[D, E]``
    (f32 whatever the compute dtype: :data:`F32_TENSORS`), the experts'
    batched ``experts_w1 [E, D, H]``, ``experts_b1 [E, H]``, ``experts_w2
    [E, H, D]``, ``experts_b2 [E, D]`` (flax's names and shapes), tanh-GELU
    and the two dropouts, in the input's dtype."""

    # A bf16 router would see other logits and pick other experts.
    F32_TENSORS = ("router",)

    def __init__(self, dim: int, num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, expand_ratio: Optional[float] = 4.0,
                 hidden_ch: Optional[int] = None, dropout_rate: float = 0.0,
                 router_z_loss_weight: float = 0.1):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        hidden = hidden_ch or int(dim * expand_ratio)
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.router_z_loss_weight = router_z_loss_weight
        self.router = nn.Parameter(torch.empty(dim, num_experts))
        self.experts_w1 = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.experts_b1 = nn.Parameter(torch.empty(num_experts, hidden))
        self.experts_w2 = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.experts_b2 = nn.Parameter(torch.empty(num_experts, dim))
        self.drop1 = Dropout(dropout_rate)
        self.drop2 = Dropout(dropout_rate)
        # Where a training forward appends its losses (sow_losses); None:
        # computed and not kept (a remat recompute, a forward outside the
        # trainer).
        self.sink: Optional[list] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: router normal(0.02), experts lecun-normal
        with flax's fan-in of a rank-3 kernel (the expert axis counts as
        receptive field: ``E·D`` and ``E·H``), zero biases."""
        nn.init.normal_(self.router, std=0.02, generator=generator)
        for w in (self.experts_w1, self.experts_w2):
            lecun_normal_(w, w.shape[0] * w.shape[1], generator)
        nn.init.zeros_(self.experts_b1)
        nn.init.zeros_(self.experts_b2)

    def capacity(self, num_tokens: int) -> int:
        """Slots per expert and group: ``max(k, ceil(cf·k·S/E))``, as
        ``sav_tpu`` forms it."""
        k = self.top_k
        return max(k, math.ceil(self.capacity_factor * k * num_tokens / self.num_experts))

    def router_logits(self, inputs: torch.Tensor) -> torch.Tensor:
        return torch.matmul(inputs.float(), self.router.float())

    def route(self, inputs: torch.Tensor) -> tuple:
        """:func:`route` of ``inputs [G, S, D]`` through this block's router."""
        return route(self.router_logits(inputs), self.top_k, self.capacity(inputs.shape[1]))

    def _losses(self, logits: torch.Tensor, probs: torch.Tensor,
                experts: torch.Tensor) -> list:
        n_exp = self.num_experts
        ids = torch.arange(n_exp, device=experts.device)
        top1 = (experts[..., 0, None] == ids).float().mean(dim=(0, 1))
        losses = [n_exp * torch.sum(top1 * probs.mean(dim=(0, 1)))]
        if self.router_z_loss_weight:
            z = torch.logsumexp(logits, dim=-1)
            losses.append(self.router_z_loss_weight * torch.mean(z * z))
        return losses

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        g, s, d = inputs.shape
        n_exp, k, dtype = self.num_experts, self.top_k, inputs.dtype
        c = self.capacity(s)
        logits = self.router_logits(inputs)
        probs, gates, experts, slots = route(logits, k, c)
        if self.training:
            # Computed in every training forward, also a remat recompute,
            # which must run the ops its forward ran.
            losses = self._losses(logits, probs, experts)
            if self.sink is not None:
                self.sink.extend(losses)

        # Dispatch: each (token, choice) into its slot; the spare slot E·C
        # takes the dropped ones and is cut off.
        flat = slots.reshape(g, s * k, 1).expand(g, s * k, d)
        tokens = inputs[:, :, None, :].expand(g, s, k, d).reshape(g, s * k, d)
        buffers = inputs.new_zeros(g, n_exp * c + 1, d).scatter(1, flat, tokens)
        xe = buffers[:, :n_exp * c].view(g, n_exp, c, d).transpose(0, 1).reshape(n_exp, g * c, d)

        # The experts, batched over E: [E, G·C, D] → [E, G·C, H] → [E, G·C, D].
        h = torch.bmm(xe, self.experts_w1.to(dtype)) + self.experts_b1.to(dtype)[:, None, :]
        h = self.drop1(F.gelu(h, approximate="tanh").view(n_exp, g, c, -1))
        ye = torch.bmm(h.view(n_exp, g * c, -1), self.experts_w2.to(dtype))
        ye = ye + self.experts_b2.to(dtype)[:, None, :]

        # Combine: gather each choice's output (the spare slot reads 0) and
        # sum the choices under the gates rounded to the compute dtype, in
        # f32 and rounded once, as a dot sums them.
        ye = ye.view(n_exp, g, c, d).transpose(0, 1).reshape(g, n_exp * c, d)
        ye = torch.cat([ye, ye.new_zeros(g, 1, d)], dim=1)
        chosen = ye.gather(1, flat).view(g, s, k, d)
        y = (chosen.float() * gates.to(dtype).float()[..., None]).sum(dim=2)
        return self.drop2(y.to(dtype))


@contextlib.contextmanager
def sow_losses(model: nn.Module):
    """Collect the losses every :class:`MoEFFBlock` of ``model`` computes in
    the training forwards run inside the block: yields the list they are
    appended to (empty for a model without one). The blocks keep nothing
    after it, so a remat recompute in the backward appends nowhere."""
    sink: list = []
    blocks = [m for m in model.modules() if isinstance(m, MoEFFBlock)]
    for block in blocks:
        block.sink = sink
    try:
        yield sink
    finally:
        for block in blocks:
            block.sink = None
