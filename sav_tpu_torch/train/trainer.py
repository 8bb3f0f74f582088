"""Single-device trainer (port of the step core of ``sav_tpu/train/trainer.py``).

One model on one device, f32 parameters with the forward and backward in
the compute dtype (bf16 by default): each attention core runs its forward
kernel and, in the backward, its backward kernels
(:mod:`sav_tpu_torch.ops.fused_attention`, past the fused backward's band
:mod:`sav_tpu_torch.ops.flash_attention`, and for CaiT's talking-heads
trunk :mod:`sav_tpu_torch.ops.talking_heads`, for BoTNet's relative-position
attention the rel kernels of :mod:`sav_tpu_torch.ops.flash_attention`). A
model with BatchNorm (BoTNet) updates its running statistics in
:meth:`Trainer.train_step` (train mode) and uses them in
:meth:`Trainer.eval_step` (eval mode); the state's ``batch_stats`` are those
buffers. A ViT built with
``model_overrides={'remat': True}`` recomputes each encoder block in the
backward pass. Stochastic depth draws its
masks from a generator on the device seeded from ``config.seed`` and used by
nothing else (``sav_tpu``'s ``'stochastic_depth'`` stream). The step is ``sav_tpu``'s
``_train_step_impl`` for ``grad_accum_steps == 1``: one-hot f32 labels
(mixed by ``mix_labels``/``ratio`` when the batch has them), label smoothing,
f32 cross entropy, backward, the masked AdamW of
:mod:`sav_tpu_torch.train.optimizer`.

Metrics stay on the device as 0-d tensors; :meth:`Trainer.fit` brings a log
window's metrics to the host in one copy. Without a card the trainer
refuses to run unless the caller passes ``device="cpu"``.

Not ported yet (ROADMAP queue A4/A6/A9/A10): checkpointing (and so
``warm_start_from``; the position-table surgery itself is
:mod:`sav_tpu_torch.models.surgery`), dropout, gradient accumulation, the
async device feed,
on-device mixing, meshes, evaluation inside ``fit`` and the telemetry.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import set_stochastic_depth_generator
from sav_tpu_torch.train.config import TrainConfig
from sav_tpu_torch.train.optimizer import (
    global_norm,
    make_optimizer,
    warmup_cosine_schedule,
    weight_decay_mask,
)
from sav_tpu_torch.train.state import TrainState
from sav_tpu_torch.utils.device import COMPUTE_DTYPES, require_device
from sav_tpu_torch.utils.metrics import cross_entropy, topk_correct


class Trainer:
    """``Trainer(config, model=None, device="cuda")``.

    Without ``model`` the trainer builds ``config.model_name`` and draws its
    parameters in :meth:`init_state`; a passed model keeps the parameters it
    has. Either way the parameters live on ``device`` in f32.
    """

    def __init__(self, config: TrainConfig, *, model: Optional[nn.Module] = None,
                 device: str = "cuda"):
        self.config = config
        self.device = require_device(device)
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]
        self._model_passed = model is not None
        if model is None:
            model = create_model(
                config.model_name,
                num_classes=config.num_classes,
                image_size=config.image_size,
                backend=config.attention_backend,
                logits_dtype=config.attention_logits_dtype,
                seed=config.seed,
                **(config.model_overrides or {}),
            )
        self.model = model.to(device=self.device, dtype=torch.float32)
        self.sd_generator = torch.Generator(device=self.device).manual_seed(config.seed)
        set_stochastic_depth_generator(self.model, self.sd_generator)
        self.schedule = warmup_cosine_schedule(
            config.learning_rate,
            steps_per_epoch=config.steps_per_epoch,
            warmup_epochs=config.warmup_epochs,
            num_epochs=config.num_epochs,
            end_lr=config.end_lr,
        )
        self.tx = make_optimizer(
            self.schedule,
            weight_decay=config.weight_decay,
            clip_grad_norm=config.clip_grad_norm,
            ema_decay=config.ema_decay,
        )
        named = list(self.model.named_parameters())
        self._param_names = [name for name, _ in named]
        mask = weight_decay_mask(named)
        self._decay_mask = [mask[name] for name in self._param_names]

    # ------------------------------------------------------------------ init

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state at step 0 with a fresh optimizer. The parameters are
        drawn from ``seed`` (default ``config.seed``) when the trainer built
        the model or a seed is given; a passed model otherwise keeps its
        parameters; BatchNorm running statistics are reset with the
        parameters they belong to. The stochastic-depth generator restarts
        from ``config.seed``."""
        if seed is not None or not self._model_passed:
            seed = self.config.seed if seed is None else seed
            generator = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                cpu = self.model.to("cpu")
                cpu.reset_parameters(generator)
                self.model = cpu.to(self.device)
        self.sd_generator.manual_seed(self.config.seed)
        params = list(self.model.parameters())
        return TrainState(step=0, model=self.model, opt_state=self.tx.init(params),
                          batch_stats=dict(self.model.named_buffers()))

    # ----------------------------------------------------------------- steps

    def _prep_images(self, images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if images.dtype == torch.uint8:
            raise ValueError(
                "got uint8 images; the trainer takes normalized float batches "
                "(on-device normalisation for training is ROADMAP queue A6)"
            )
        if self.config.transpose_images and images.ndim == 4:
            images = images.permute(3, 0, 1, 2)  # HWCN → NHWC
        return images.to(self.device, non_blocking=True).to(self.compute_dtype)

    def _labels(self, batch: dict) -> torch.Tensor:
        return torch.as_tensor(batch["labels"]).to(self.device, torch.int64)

    def _label_probs(self, batch: dict, labels: torch.Tensor) -> torch.Tensor:
        num_classes = self.config.num_classes
        probs = F.one_hot(labels, num_classes).float()
        if "mix_labels" in batch:
            ratio = torch.as_tensor(batch["ratio"]).to(self.device, torch.float32)[:, None]
            mix = torch.as_tensor(batch["mix_labels"]).to(self.device, torch.int64)
            probs = ratio * probs + (1.0 - ratio) * F.one_hot(mix, num_classes).float()
        alpha = self.config.label_smoothing
        if alpha > 0.0:
            # optax.smooth_labels
            probs = (1.0 - alpha) * probs + alpha / num_classes
        return probs

    def train_step(self, state: TrainState, batch: dict):
        """One update on a host (numpy) or device batch
        (``images``, ``labels``, optional ``mix_labels``/``ratio``).
        Updates the model and optimizer state in place; returns the state at
        ``step + 1`` and the step's metrics as 0-d device tensors (and the
        schedule's learning rate as a float)."""
        model = state.model
        model.train()
        images = self._prep_images(batch["images"])
        labels = self._labels(batch)
        label_probs = self._label_probs(batch, labels)
        params = list(model.parameters())
        logits = model(images)
        aux_loss = torch.zeros((), device=self.device)  # ViT sows no auxiliary loss
        loss = cross_entropy(logits, label_probs) + self.config.aux_loss_weight * aux_loss
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            grad_norm = global_norm(grads)  # before the clip, as sav_tpu logs it
            opt_state = self.tx.step(
                params, list(grads), self._decay_mask, state.opt_state, grad_norm=grad_norm
            )
            acc = topk_correct(logits.detach().float(), labels)
        metrics = {
            "loss": loss.detach(),
            "top_1_acc": acc["top_1_acc"].mean(),
            "top_5_acc": acc["top_5_acc"].mean(),
            "learning_rate": self.schedule(state.step),
            "grad_norm": grad_norm,
            "aux_loss": aux_loss,
        }
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """Summed loss (no label smoothing), top-1/top-5 hits and count over
        the batch's valid rows (``valid``, default all), as device tensors;
        on the parameter EMA when configured."""
        images = self._prep_images(batch["images"])
        model = state.model
        model.eval()
        if state.opt_state.ema is not None:
            ema = dict(zip(self._param_names, state.opt_state.ema))
            logits = torch.func.functional_call(model, ema, (images,))
        else:
            logits = model(images)
        logits = logits.float()
        labels = self._labels(batch)
        valid = batch.get("valid")
        valid = (
            torch.ones(labels.shape, device=self.device) if valid is None
            else torch.as_tensor(valid).to(self.device, torch.float32)
        )
        acc = topk_correct(logits, labels)
        per_example = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        return {
            "loss_sum": (per_example * valid).sum(),
            "top_1_sum": (acc["top_1_acc"] * valid).sum(),
            "top_5_sum": (acc["top_5_acc"] * valid).sum(),
            "count": valid.sum(),
        }

    # ------------------------------------------------------------------ loop

    def fit(
        self,
        train_iter: Iterator[dict],
        *,
        num_steps: Optional[int] = None,
        state: Optional[TrainState] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
    ):
        """Run ``num_steps`` steps (default ``config.total_steps``) from
        ``state`` (default :meth:`init_state`). Every ``log_every_steps`` steps
        and at the end, the window's metrics reach the host in one copy; each
        step's become a record in the returned history, and ``log_fn`` gets
        the window's last record with ``step``, ``step_s`` and
        ``images_per_sec`` over the window. Returns ``(state, history)``."""
        cfg = self.config
        num_steps = cfg.total_steps if num_steps is None else num_steps
        state = self.init_state() if state is None else state
        train_iter = iter(train_iter)
        history, window = [], []
        t_last = time.perf_counter()
        for i in range(num_steps):
            state, metrics = self.train_step(state, next(train_iter))
            window.append(metrics)
            if (i + 1) % cfg.log_every_steps and i + 1 != num_steps:
                continue
            records = _to_host(window)
            now = time.perf_counter()
            step_s = (now - t_last) / len(window)
            for offset, record in enumerate(records):
                record["step"] = state.step - len(records) + offset + 1
            records[-1]["step_s"] = step_s
            records[-1]["images_per_sec"] = cfg.global_batch_size / step_s
            history.extend(records)
            if log_fn is not None:
                log_fn(records[-1])
            window, t_last = [], now
        return state, history


def _to_host(window: list) -> list:
    """A window's step metrics as host dicts: the tensors of every step go
    to the host in one copy (which waits for the device)."""
    keys = [k for k, v in window[0].items() if torch.is_tensor(v)]
    rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in window])
    values = rows.cpu().numpy().astype(np.float64)
    records = []
    for metrics, row in zip(window, values):
        record = {k: float(v) for k, v in metrics.items() if not torch.is_tensor(v)}
        record.update({k: float(x) for k, x in zip(keys, row)})
        records.append(record)
    return records
