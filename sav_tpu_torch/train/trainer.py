"""Single-device trainer (port of ``sav_tpu/train/trainer.py``).

One model on one device, f32 parameters with the forward and backward in
the compute dtype (bf16 by default): each attention core runs its forward
kernel and, in the backward, its backward kernels
(:mod:`sav_tpu_torch.ops.fused_attention`, past the fused backward's band
:mod:`sav_tpu_torch.ops.flash_attention`, and for CaiT's talking-heads
trunk :mod:`sav_tpu_torch.ops.talking_heads`, for BoTNet's relative-position
attention the rel kernels of :mod:`sav_tpu_torch.ops.flash_attention`). A
model with BatchNorm (BoTNet) updates its running statistics in a train
step (train mode) and uses them in an eval step (eval mode); the state's
``batch_stats`` are those buffers. A ViT built with
``model_overrides={'remat': True}`` recomputes each encoder block in the
backward pass. Stochastic depth, dropout and the device mixes draw from
three generators on the device, used by nothing else (``sav_tpu``'s
``'stochastic_depth'`` and ``'dropout'`` streams and its dedicated mix
fold), and with ``config.quant == "int8"`` (QAT on the int8 arm of
:mod:`sav_tpu_torch.ops.quant`) the stochastic rounding of the gradient
dots from a fourth, ``"quant"`` (``sav_tpu``'s ``'quant'`` stream): the
first seeded from ``config.seed``, the others from seeds derived from it
(:func:`stream_seed`). Each micro-batch's backward draws anew, and the
captured step registers every generator, so each replay rounds with new
draws. Their states are part of the train state and
of every checkpoint, so a restored run draws what the uninterrupted run
would have drawn.

The step is ``sav_tpu``'s ``_train_step_impl``: with ``device_preprocess``
the uint8 batch is mixed (the augment string's MixUp/CutMix) and
normalised on the device first; then one-hot f32 labels (mixed by
``mix_labels``/``ratio`` when the batch has them), label smoothing, f32
cross entropy plus ``aux_loss_weight`` times the losses the forward sowed
(the MoE blocks' balance and router z-losses,
:func:`~sav_tpu_torch.models.layers.sow_losses`; logged as ``aux_loss``),
backward, the masked AdamW of
:mod:`sav_tpu_torch.train.optimizer`; with ``grad_accum_steps > 1`` the
batch is split into micro-batches whose f32 gradients are averaged before
one update (BatchNorm statistics thread through them in order).

On the card :meth:`Trainer.train_step` and :meth:`Trainer.eval_step`
replay CUDA graphs (:mod:`sav_tpu_torch.train.graphs`), captured once per
batch signature as ``jax.jit`` compiles once per shape; ``_train_step_impl``
and ``_eval_step_impl`` are the eager bodies they capture, which run as
they are on the CPU. The graphs hold the addresses of the state's tensors,
so a state that brings other tensors (``restore_or_init``,
``warm_start_from`` and ``init_state`` all make new ones) is captured
again, and :attr:`Trainer.recaptures` counts it. :meth:`Trainer.fit` and
:meth:`Trainer.evaluate` take their batches through the async
:class:`~sav_tpu_torch.data.feeder.DeviceFeeder` when ``config.async_feed``
(the default): placement of batch N+1 (pinned memory, a copy on a stream
of the trainer's own) overlaps step N.

Metrics stay on the device as 0-d tensors; :meth:`Trainer.fit` brings a log
window's metrics to the host in one copy, and saves checkpoints
(:mod:`sav_tpu_torch.train.checkpoint`) and evaluates at the cadences the
config sets, with the run telemetry of :mod:`sav_tpu_torch.obs` (goodput
ledger, spans, heartbeats, flight recorder, hang watchdog; one
:class:`~sav_tpu_torch.train.telemetry.RunTelemetry` per :meth:`Trainer.fit`); :mod:`sav_tpu_torch.train.supervisor` restarts a run
that dies. Without a card the trainer refuses to run unless the caller
passes ``device="cpu"``.

Not ported yet (ROADMAP queues A9 and A10): meshes, the profiler windows
and the diagnostics.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import sys
import time
import weakref
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.data.augment_spec import parse_augment_spec
from sav_tpu_torch.data.feeder import DeviceFeeder
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import (
    RecomputeGenerators,
    set_dropout_generator,
    set_recompute_generators,
    set_stochastic_depth_generator,
    sow_losses,
)
from sav_tpu_torch.models.surgery import adapt_pos_embeds
from sav_tpu_torch.ops import launch_counts
from sav_tpu_torch.ops.quant import set_quant_generator
from sav_tpu_torch.ops.preprocess import apply_mixes, normalize_images
from sav_tpu_torch.train.checkpoint import Checkpointer
from sav_tpu_torch.train.config import TrainConfig
from sav_tpu_torch.train.graphs import StepGraphs
from sav_tpu_torch.train.optimizer import (
    global_norm,
    make_optimizer,
    warmup_cosine_schedule,
    weight_decay_mask,
)
from sav_tpu_torch.train.state import TrainState, persistent_buffers
from sav_tpu_torch.train.telemetry import RunTelemetry
from sav_tpu_torch.utils.debug import assert_all_finite
from sav_tpu_torch.utils.device import COMPUTE_DTYPES, require_device
from sav_tpu_torch.utils.graphs import held_stream
from sav_tpu_torch.utils.metrics import cross_entropy, topk_correct

_TRAIN_KEYS = ("loss", "top_1_acc", "top_5_acc", "learning_rate", "grad_norm", "aux_loss")
_EVAL_KEYS = ("loss_sum", "top_1_sum", "top_5_sum", "count")


def stream_seed(seed: int, stream: str) -> int:
    """The seed of a named generator stream derived from the run's ``seed``:
    the first 8 bytes of ``sha256(f"{seed}/{stream}")``, so no stream shares
    a seed with another run's."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{stream}".encode()).digest()[:8], "little")


class PlacedBatch(dict):
    """A batch on the trainer's device (:meth:`Trainer.shard_batch`). On the
    card ``event`` marks the end of its copy, which the step that reads it
    waits on."""

    event: Optional["torch.cuda.Event"] = None


@dataclasses.dataclass
class CompiledStep:
    """The train step captured for one batch signature
    (:meth:`Trainer.compile_train_step`): call it as ``step(state, placed)``.
    ``capture_s`` is the capture's time, warm-ups included, and
    ``captured_launches``/``captured_variants`` the kernel launches one
    replay runs (empty on the CPU, where the step runs eagerly)."""

    step: Callable
    capture_s: float
    captured_launches: dict
    captured_variants: dict

    def __call__(self, state: TrainState, placed: dict):
        return self.step(state, placed)


class Trainer:
    """``Trainer(config, model=None, checkpointer=None, device="cuda")``.

    Without ``model`` the trainer builds ``config.model_name`` and draws its
    parameters in :meth:`init_state`; a passed model keeps the parameters it
    has. Either way the parameters live on ``device`` in f32. Without
    ``checkpointer`` one is opened on ``config.checkpoint_dir`` when that is
    set (keeping ``config.checkpoint_keep`` steps).
    """

    def __init__(self, config: TrainConfig, *, model: Optional[nn.Module] = None,
                 checkpointer: Optional[Checkpointer] = None, device: str = "cuda"):
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
                quant=config.quant,
                **(config.model_overrides or {}),
            )
        elif getattr(model, "quant", None) != config.quant:
            raise ValueError(
                f"config.quant={config.quant!r} but the passed model was built with "
                f"quant={getattr(model, 'quant', None)!r}; build it with "
                "create_model(..., quant=config.quant)"
            )
        self.model = model.to(device=self.device, dtype=torch.float32)
        self.generators = {
            "stochastic_depth": torch.Generator(device=self.device),
            "dropout": torch.Generator(device=self.device),
            "mix": torch.Generator(device=self.device),
        }
        if config.quant:
            self.generators["quant"] = torch.Generator(device=self.device)
        self._seed_generators()
        # device_preprocess: the host ships post-augment uint8 and the step
        # applies the augment string's mixes, then normalises.
        self._mix_spec = parse_augment_spec(config.augment) if config.device_preprocess else None
        set_stochastic_depth_generator(self.model, self.generators["stochastic_depth"])
        set_dropout_generator(self.model, self.generators["dropout"])
        if config.quant:
            set_quant_generator(self.model, self.generators["quant"])
        # The twins that blocks recomputed under remat draw from again.
        self.recompute_generators = RecomputeGenerators()
        set_recompute_generators(self.model, self.recompute_generators)
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
        # {"transferred", "fresh"} tensor counts of the last warm_start_from.
        self.last_warm_start: Optional[dict] = None
        self.checkpointer = checkpointer
        if checkpointer is None and config.checkpoint_dir:
            self.checkpointer = Checkpointer(config.checkpoint_dir, keep=config.checkpoint_keep)
        on_card = self.device.type == "cuda"
        # Batches are copied to the card on a stream of the trainer's own.
        self._feed_stream = held_stream(self.device, self) if on_card else None
        # {"train"|"eval": (state key, StepGraphs)} on the card.
        self._graphs: dict = {}
        # Captures made again because a state brought other tensors.
        self.recaptures = 0
        # The feeder's stats() of the last fit (None without async_feed).
        self.last_feeder_stats: Optional[dict] = None

    def _seed_generators(self) -> None:
        seed = self.config.seed
        self.generators["stochastic_depth"].manual_seed(seed)
        self.generators["dropout"].manual_seed(stream_seed(seed, "dropout"))
        self.generators["mix"].manual_seed(stream_seed(seed, "mix"))
        if "quant" in self.generators:
            self.generators["quant"].manual_seed(stream_seed(seed, "quant"))

    # ------------------------------------------------------------------ init

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state at step 0 with a fresh optimizer. The parameters are
        drawn from ``seed`` (default ``config.seed``) when the trainer built
        the model or a seed is given; a passed model otherwise keeps its
        parameters; BatchNorm running statistics are reset with the
        parameters they belong to. The generators restart from their
        seeds."""
        if seed is not None or not self._model_passed:
            seed = self.config.seed if seed is None else seed
            generator = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                cpu = self.model.to("cpu")
                cpu.reset_parameters(generator)
                self.model = cpu.to(self.device)
        self._seed_generators()
        params = list(self.model.parameters())
        return TrainState(step=0, model=self.model, opt_state=self.tx.init(params),
                          batch_stats=persistent_buffers(self.model),
                          generators=dict(self.generators))

    def restore_or_init(self) -> TrainState:
        """The newest checkpoint of ``self.checkpointer`` restored into a
        fresh state (falling back to older steps, see
        :meth:`Checkpointer.restore_latest`), or the fresh state when there is
        none."""
        state = self.init_state()
        if self.checkpointer is not None:
            restored = self.checkpointer.restore_latest(state)
            if restored is not None:
                return restored
        return state

    def warm_start_from(self, directory: str) -> TrainState:
        """A fresh state (step 0, fresh optimizer) with the parameters and
        ``batch_stats`` of another run's newest checkpoint: position tables
        are resampled to this model's token count
        (:func:`~sav_tpu_torch.models.surgery.adapt_pos_embeds`, the
        224² → 384² fine-tune recipe); any other missing tensor or other
        shape (a head of another width) keeps its fresh value, with a
        warning. The parameter EMA, when configured, restarts from the
        transferred weights."""
        source = Checkpointer(directory, read_only=True)
        raw = source.restore_raw()
        source.close()
        if raw is None:
            raise FileNotFoundError(f"no checkpoint found in {directory!r}")
        fresh = self.init_state()
        counts = {"transferred": 0, "fresh": 0}

        def merge(saved: dict, live: dict, collection: str) -> None:
            for name, tensor in live.items():
                src = saved.get(name)
                if src is None or tuple(src.shape) != tuple(tensor.shape):
                    logging.warning(
                        "warm start: %s %s %s; keeping fresh init", collection, name,
                        "not in source" if src is None
                        else f"shape {tuple(src.shape)} != {tuple(tensor.shape)}",
                    )
                    counts["fresh"] += 1
                    continue
                tensor.copy_(src)
                counts["transferred"] += 1

        params = fresh.params
        with torch.no_grad():
            merge(adapt_pos_embeds(raw["params"], params), params, "params")
            merge(raw.get("batch_stats", {}), fresh.batch_stats, "batch_stats")
            if fresh.opt_state.ema is not None:
                for ema, param in zip(fresh.opt_state.ema, params.values()):
                    ema.copy_(param)
        logging.warning("warm start from %s: %d tensors transferred, %d fresh",
                        directory, counts["transferred"], counts["fresh"])
        self.last_warm_start = counts
        return fresh

    # ----------------------------------------------------------------- steps

    def _prep_images(self, images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if images.dtype == torch.uint8:
            raise ValueError(
                "got uint8 images with device_preprocess=False; either set "
                "TrainConfig.device_preprocess=True or feed normalized "
                "float batches (load(device_preprocess=...) must match the "
                "trainer)"
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

    def _device_preprocess(self, batch: dict, training: bool) -> dict:
        """A uint8 batch → mixed (in training, as the augment string says)
        and normalised NHWC images in the compute dtype, on the device
        (``sav_tpu``'s ``_device_preprocess``; the mixes draw from the
        ``"mix"`` generator)."""
        images = torch.as_tensor(batch["images"]).to(self.device, non_blocking=True)
        if images.dtype != torch.uint8:
            raise ValueError(
                "device_preprocess=True expects uint8 batches from the "
                f"matching pipeline mode, got {images.dtype}; feed "
                "load(device_preprocess=True) / "
                "savrec_train_iterator(normalize=False) batches, or turn "
                "device_preprocess off"
            )
        if self.config.transpose_images and images.ndim == 4:
            images = images.permute(3, 0, 1, 2)  # HWCN → NHWC
        batch = dict(batch)
        if training and self._mix_spec is not None and self._mix_spec.mixes:
            images, mix_labels, ratio = apply_mixes(
                images, self._labels(batch), self._mix_spec, generator=self.generators["mix"])
            if mix_labels is not None:
                batch["mix_labels"] = mix_labels
                batch["ratio"] = ratio
        batch["images"] = normalize_images(images, self.compute_dtype)
        return batch

    def _inputs(self, batch: dict, training: bool) -> tuple:
        """``(batch, NHWC images in the compute dtype)``: the batch with the
        mixes' labels when ``device_preprocess`` added them."""
        if self.config.device_preprocess:
            batch = self._device_preprocess(batch, training)
            return batch, batch["images"]
        return batch, self._prep_images(batch["images"])

    def _train_step_impl(self, state: TrainState, batch: dict):
        """One update, eagerly: the body that :meth:`train_step` captures on
        the card and runs as it is on the CPU. Takes a host (numpy) or
        device batch (``images``, ``labels``, optional
        ``mix_labels``/``ratio``); updates the model and optimizer state in
        place; returns the state at ``step + 1`` and the step's metrics as
        0-d device tensors.

        With ``grad_accum_steps`` > 1 the batch is split into that many
        micro-batches, run in order (each BatchNorm normalises by its
        micro-batch and updates the running statistics the next one sees,
        as ``sav_tpu``'s scan carries them); their f32 gradients are summed
        and divided by the count, the loss is the micro-batches' mean, the
        top-k metrics are taken on their concatenated logits, and the one
        update and ``grad_norm`` use the averaged gradients."""
        model = state.model
        model.train()
        self.recompute_generators.begin_step(self.generators.values())
        batch, images = self._inputs(batch, training=True)
        labels = self._labels(batch)
        label_probs = self._label_probs(batch, labels)
        params = list(model.parameters())
        accum = self.config.grad_accum_steps
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum_steps {accum}")
        grads, loss, aux_loss, logits = None, None, None, []
        for micro_images, micro_probs in zip(images.split(b // accum),
                                             label_probs.split(b // accum)):
            with sow_losses(model) as sown:
                micro_logits = model(micro_images)
            # The sown losses at their relative scales, summed in f32 (0 for
            # a model that sows none); aux_loss_weight turns them into loss
            # units, as sav_tpu's loss_fn does.
            micro_aux = (torch.stack([x.float() for x in sown]).sum() if sown
                         else torch.zeros((), device=self.device))
            micro_loss = (cross_entropy(micro_logits, micro_probs)
                          + self.config.aux_loss_weight * micro_aux)
            micro_grads = torch.autograd.grad(micro_loss, params)
            if grads is None:
                grads, loss, aux_loss = list(micro_grads), micro_loss.detach(), micro_aux.detach()
            else:
                torch._foreach_add_(grads, micro_grads)
                loss = loss + micro_loss.detach()
                aux_loss = aux_loss + micro_aux.detach()
            logits.append(micro_logits.detach())
        if accum > 1:
            torch._foreach_div_(grads, accum)
            loss = loss / accum
            aux_loss = aux_loss / accum
        with torch.no_grad():
            grad_norm = global_norm(grads)  # before the clip, as sav_tpu logs it
            learning_rate = self.schedule(state.opt_state.count)  # the update's, as sav_tpu's
            opt_state = self.tx.step(
                params, grads, self._decay_mask, state.opt_state, grad_norm=grad_norm,
                lr=learning_rate,
            )
            acc = topk_correct(torch.cat(logits).float(), labels)
        metrics = {
            "loss": loss,
            "top_1_acc": acc["top_1_acc"].mean(),
            "top_5_acc": acc["top_5_acc"].mean(),
            "learning_rate": learning_rate,
            "grad_norm": grad_norm,
            "aux_loss": aux_loss,
        }
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    @torch.no_grad()
    def _eval_step_impl(self, state: TrainState, batch: dict) -> dict:
        """Summed loss (no label smoothing), top-1/top-5 hits and count over
        the batch's valid rows (``valid``, default all), as device tensors;
        on the parameter EMA when configured. The eager body of
        :meth:`eval_step`."""
        batch, images = self._inputs(batch, training=False)
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

    # ------------------------------------------------------- placement, graphs

    def shard_batch(self, batch: dict) -> PlacedBatch:
        """Place a host batch on the trainer's device (``sav_tpu``'s name;
        one device, so nothing is sharded). On the card each host array is
        copied into pinned memory and from there to the card on the
        trainer's own stream, without a wait; the batch's ``event`` marks
        the end of the copies. A tensor already on the device is taken as
        it is. Safe to call from the feeder's thread."""
        if isinstance(batch, PlacedBatch):
            return batch
        placed = PlacedBatch()
        if self._feed_stream is None:
            placed.update({k: torch.as_tensor(v).to(self.device) for k, v in batch.items()})
            return placed
        with torch.cuda.stream(self._feed_stream):
            for key, value in batch.items():
                value = torch.as_tensor(value)
                if value.device.type == "cpu":
                    if not value.is_pinned():
                        pinned = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                        pinned.copy_(value)
                        value = pinned
                    value = value.to(self.device, non_blocking=True)
                placed[key] = value
            placed.event = torch.cuda.Event()
            placed.event.record()
        return placed

    def _await(self, placed: dict) -> None:
        """Order the current stream after ``placed``'s copies, and keep the
        allocator from reusing their blocks before it has read them."""
        event = getattr(placed, "event", None)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for value in placed.values():
                value.record_stream(stream)

    def _state_tensors(self, state: TrainState) -> list:
        """Every tensor a train step updates in place: parameters, buffers
        (the BatchNorm statistics), Adam moments, the EMA and the count."""
        opt = state.opt_state
        return [*state.model.parameters(), *state.model.buffers(), *opt.mu, *opt.nu,
                *(opt.ema or ()), opt.count]

    def _step_graphs(self, state: TrainState, kind: str) -> StepGraphs:
        """The trainer's ``StepGraphs`` of ``kind`` ("train" or "eval") for
        ``state``: kept while the state's tensors are the ones it was
        captured on. A state that brings others drops the graphs of both
        kinds, and this one is captured anew (counted in
        :attr:`recaptures`)."""
        tensors = self._state_tensors(state)
        key = (id(state.model), tuple(t.data_ptr() for t in tensors))
        if any(held_key != key for held_key, _ in self._graphs.values()):
            # Every graph of the old state goes, of either kind: each keeps
            # that state's tensors and its pool alive.
            self.recaptures += 1
            self._graphs.clear()
            logging.info("%s step: the state brings other tensors; capturing again", kind)
        if kind in self._graphs:
            return self._graphs[kind][1]
        # The graphs reach the trainer through a weak reference: a cycle
        # would keep the trainer's device memory until a collection.
        body = weakref.WeakMethod(self._train_body if kind == "train" else self._eval_body)

        def step(batch: dict) -> torch.Tensor:
            return body()(state, batch)

        if kind == "train":
            graphs = StepGraphs(step, self.device, tensors=tensors,
                                generators=list(self.generators.values()),
                                recompute=self.recompute_generators)
        else:
            graphs = StepGraphs(step, self.device)
        self._graphs[kind] = (key, graphs)
        return graphs

    def _train_body(self, state: TrainState, batch: dict) -> torch.Tensor:
        _, metrics = self._train_step_impl(state, batch)
        return torch.stack([metrics[k].float() for k in _TRAIN_KEYS])

    def _eval_body(self, state: TrainState, batch: dict) -> torch.Tensor:
        sums = self._eval_step_impl(state, batch)
        return torch.stack([sums[k] for k in _EVAL_KEYS])

    @property
    def train_graphs(self) -> Optional[StepGraphs]:
        """The captured train step's graphs (None before the first step on
        the card)."""
        held = self._graphs.get("train")
        return None if held is None else held[1]

    @property
    def eval_graphs(self) -> Optional[StepGraphs]:
        held = self._graphs.get("eval")
        return None if held is None else held[1]

    # ----------------------------------------------------------- step API

    def train_step(self, state: TrainState, batch: dict):
        """One update on a host (numpy) or device batch (``images``,
        ``labels``, optional ``mix_labels``/``ratio``): placed
        (:meth:`shard_batch`), then :meth:`train_step_placed`. Returns the
        state at ``step + 1`` and the step's metrics as 0-d device
        tensors."""
        return self.train_step_placed(state, self.shard_batch(batch))

    def train_step_placed(self, state: TrainState, placed: dict):
        """One update on a batch already on the device (from
        :meth:`shard_batch`, or the feeder). On the card it replays the step
        captured for the batch's signature (capturing it first); on the CPU
        it runs :meth:`_train_step_impl`. The state's tensors are updated in
        place either way."""
        if self._feed_stream is None:
            return self._train_step_impl(state, placed)
        self._await(placed)
        packed = self._step_graphs(state, "train")(placed).clone()
        return (dataclasses.replace(state, step=state.step + 1),
                dict(zip(_TRAIN_KEYS, packed.unbind())))

    def compile_train_step(self, state: TrainState, placed: dict) -> CompiledStep:
        """Capture the train step for ``placed``'s signature now (warm-ups
        and capture, which leave the state as it was) and return it: the
        counterpart of ``sav_tpu``'s AOT ``compile_train_step``, with the
        capture's time and the launches one replay runs."""
        if self._feed_stream is None:
            return CompiledStep(self.train_step_placed, 0.0, {}, {})
        self._await(placed)
        graphs = self._step_graphs(state, "train")
        key = graphs.capture(placed)
        return CompiledStep(self.train_step_placed, graphs.capture_s[key],
                            graphs.captured_launches[key], graphs.captured_variants[key])

    def train_many_steps(self, state: TrainState, batches: dict):
        """``K`` steps over ``batches`` whose leaves carry a leading
        ``[K, ...]`` axis, placed in one copy: ``K`` replays on the card (K
        eager steps on the CPU). Returns the state and the metrics stacked
        ``[K]``, as ``sav_tpu``'s ``lax.scan``."""
        placed = self.shard_batch(batches)
        self._await(placed)
        steps = len(placed["labels"])
        per_step = []
        for i in range(steps):
            state, metrics = self.train_step_placed(state, {k: v[i] for k, v in placed.items()})
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in _TRAIN_KEYS}

    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """Summed loss (no label smoothing), top-1/top-5 hits and count over
        the batch's valid rows (``valid``, default all), as device tensors;
        on the parameter EMA when configured. On the card a replay of the
        eval step captured for the batch's signature."""
        if self._feed_stream is None:
            return self._eval_step_impl(state, batch)
        placed = self.shard_batch(batch)
        self._await(placed)
        packed = self._step_graphs(state, "eval")(placed).clone()
        return dict(zip(_EVAL_KEYS, packed.unbind()))

    def _pad_eval_batch(self, batch: dict, target: int) -> dict:
        """A short batch zero-padded to ``target`` rows, with ``valid`` 1 on
        its rows and 0 on the padding (numpy or torch leaves; HWCN images
        pad their last axis)."""
        n = len(batch["labels"])
        pad = target - n
        transposed = self.config.transpose_images

        def pad_leaf(key, x):
            axis = x.ndim - 1 if (key == "images" and transposed) else 0
            if torch.is_tensor(x):
                shape = list(x.shape)
                shape[axis] = pad
                return torch.cat([x, x.new_zeros(shape)], dim=axis)
            x = np.asarray(x)
            widths = [(0, 0)] * x.ndim
            widths[axis] = (0, pad)
            return np.pad(x, widths)

        out = {k: pad_leaf(k, v) for k, v in batch.items()}
        out["valid"] = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        return out

    def evaluate(self, state: TrainState, eval_iter: Iterator[dict]) -> dict:
        """One evaluation pass: ``{"eval_loss", "eval_top_1_acc",
        "eval_top_5_acc", "eval_count"}``. The first batch fixes the batch
        size; a shorter batch is padded (:meth:`_pad_eval_batch`) and every
        other batch gets an all-ones ``valid``, so on the card one captured
        eval step serves the pass. With ``config.async_feed`` padding and
        placement run on the feeder's thread. The per-batch sums stay on
        the device and reach the host in one copy at the end; the host runs
        at most ``feed_depth + 1`` batches ahead of the device (each batch
        in flight holds its inputs there)."""
        batch_size: Optional[int] = None

        def place(batch: dict) -> dict:
            # The one feeder worker places in order: the first batch fixes
            # the size before any other is padded.
            nonlocal batch_size
            n = len(batch["labels"])
            if batch_size is None:
                batch_size = n
            if n < batch_size:
                batch = self._pad_eval_batch(batch, batch_size)
            elif "valid" not in batch:
                batch = {**batch, "valid": np.ones(n, np.float32)}
            return self.shard_batch(batch)

        sums, fences = [], []
        max_inflight = self.config.feed_depth + 1
        retired = 0
        eval_iter = iter(eval_iter)
        feeder = (DeviceFeeder(eval_iter, place, depth=self.config.feed_depth, name="eval-feeder")
                  if self.config.async_feed else None)
        try:
            for placed in (feeder if feeder is not None else map(place, eval_iter)):
                step_sums = self.eval_step(state, placed)
                sums.append(torch.stack([step_sums[k] for k in _EVAL_KEYS]))
                if self.device.type == "cuda":
                    fences.append(torch.cuda.Event())
                    fences[-1].record()
                    if len(fences) - retired >= max_inflight:
                        fences[retired].synchronize()
                        retired += 1
        finally:
            if feeder is not None:
                feeder.close()
        totals = (torch.stack(sums).cpu().numpy().astype(np.float64).sum(axis=0)
                  if sums else np.zeros(len(_EVAL_KEYS)))
        totals = dict(zip(_EVAL_KEYS, totals.tolist()))
        n = max(totals["count"], 1.0)
        return {
            "eval_loss": totals["loss_sum"] / n,
            "eval_top_1_acc": totals["top_1_sum"] / n,
            "eval_top_5_acc": totals["top_5_sum"] / n,
            "eval_count": n,
        }

    # ----------------------------------------------------------- checkpoints

    def _save_with_stamp(self, step: int, state: TrainState) -> None:
        """One checkpoint save and the resume stamp, ``resume.json`` beside
        the steps: ``(epoch, step in epoch, seed, feeder position)`` and
        how the generators are derived, as provenance. The checkpoint's own
        step stays authoritative; the stamp is written when the save is
        requested, so it may run one save ahead of the last committed
        step."""
        cfg = self.config
        self.checkpointer.save(step, state, config=cfg.to_json())
        spe = max(cfg.steps_per_epoch, 1)
        stamp = {
            "schema": 1,
            "step": int(step),
            "epoch": int(step // spe),
            "step_in_epoch": int(step % spe),
            "steps_per_epoch": spe,
            "seed": cfg.seed,
            "feeder_position": int(step),
            "rng": {
                "derivation":
                    "torch.Generator(device).manual_seed(seed) for 'stochastic_depth', "
                    "manual_seed(stream_seed(seed, 'dropout')) for 'dropout', "
                    "manual_seed(stream_seed(seed, 'mix')) for 'mix' (device_preprocess's "
                    "mixes), manual_seed(stream_seed(seed, 'quant')) for 'quant' (the int8 "
                    "arm's stochastic rounding, QAT runs only); each resumes from its "
                    "state saved in generators.pt",
                "generators": sorted(state.generators),
            },
            "saved_unix": round(time.time(), 3),
        }
        path = os.path.join(self.checkpointer.directory, "resume.json")
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(stamp, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            pass  # provenance, never fatal

    # ------------------------------------------------------------------ loop

    def fit(
        self,
        train_iter: Iterator[dict],
        *,
        num_steps: Optional[int] = None,
        eval_iter_fn: Optional[Callable[[], Iterator[dict]]] = None,
        state: Optional[TrainState] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
        manifest=None,
    ):
        """Train from ``state`` (default :meth:`restore_or_init`) up to step
        ``num_steps`` in all (default ``config.total_steps``): the loop runs
        from ``state.step``, and stops early when ``train_iter`` ends (closing
        the log window there).

        With ``config.async_feed`` (the default) a
        :class:`~sav_tpu_torch.data.feeder.DeviceFeeder` fetches and places
        the batches (:meth:`shard_batch`) on its own thread, at most
        ``feed_depth + 1`` ahead of the step; it is closed when the loop
        ends, early or by an exception (which propagates), and its
        ``stats()`` join the last train record as ``feeder_*`` keys.
        Without it the loop fetches, places and steps in turn.

        A log window closes where ``(step + 1) % log_every_steps == 0`` and at
        the last step, on the global step: its metrics reach the host in one
        copy, each step's become a record in the returned history, and
        ``log_fn`` gets the window's last record with ``step``, ``step_s`` and
        ``images_per_sec`` over the window. With a checkpointer, a save
        follows a log boundary once ``checkpoint_every_steps`` steps have
        passed since the last save (or the start), or
        ``checkpoint_every_secs`` seconds; and an epoch end saves every
        ``checkpoint_every_epochs`` epochs. At an epoch end where
        ``epoch % eval_every_epochs == 0``, :meth:`evaluate` runs on a fresh
        ``eval_iter_fn()``; its record, with ``step``, joins the history and
        goes to ``log_fn``. The last step is saved when it was not, and the
        writes are waited for. Returns ``(state, history)``.

        Run telemetry (``sav_tpu``'s): one
        :class:`~sav_tpu_torch.train.telemetry.RunTelemetry` into the sink
        ``config.log_dir or config.checkpoint_dir``, nothing without one (a
        goodput ledger always, ``self.last_goodput``; spans, heartbeats,
        the flight recorder and the hang watchdog as the config asks). With
        ``debug_nans`` every step's metrics are checked on the host (one
        small copy a step), so a nonfinite step raises
        ``FloatingPointError`` before any later save. At a log boundary, in
        order: the ledger's window, the recorder, the manifest's progress,
        the heartbeat, the save. ``manifest`` (a
        :class:`~sav_tpu_torch.obs.manifest.RunManifest`) gets the
        ``backend`` and ``kernels`` notes, the incidents and the ledger's
        metrics; the watchdog finalizes it as ``hang``. None of it adds a
        device sync beyond the log boundary's copy and ``debug_nans``'
        copy."""
        cfg = self.config
        num_steps = cfg.total_steps if num_steps is None else num_steps
        state = self.restore_or_init() if state is None else state
        start_step = state.step
        train_iter = iter(train_iter)
        history, window = [], []
        t_last = t_last_ckpt = time.perf_counter()
        timed = 0  # steps since t_last
        last_saved = None
        spe = max(cfg.steps_per_epoch, 1)
        telemetry = RunTelemetry(self, start_step, manifest)
        tracer, ledger = telemetry.tracer, telemetry.ledger
        feeder = (DeviceFeeder(train_iter, telemetry.place(self.shard_batch),
                               depth=cfg.feed_depth, name="train-feeder")
                  if cfg.async_feed else None)

        def close_window(step: int, last: bool) -> dict:
            nonlocal window, t_last, timed
            t_sync = time.perf_counter()
            with tracer.span("log_sync", step=step):
                records = _to_host(window)  # waits for the window's steps
            now = time.perf_counter()
            telemetry.window_synced(step, now - t_sync)
            step_s = (now - t_last) / max(timed, 1)
            for offset, record in enumerate(records):
                record["step"] = step - len(records) + offset + 1
            records[-1]["step_s"] = step_s
            records[-1]["images_per_sec"] = cfg.global_batch_size / step_s
            if last and feeder is not None:
                records[-1].update({f"feeder_{k}": v for k, v in feeder.stats().items()})
            history.extend(records)
            if log_fn is not None:
                log_fn(records[-1])
            window, t_last, timed = [], now, 0
            return records[-1]

        def save(step: int) -> None:
            nonlocal last_saved, t_last_ckpt
            with tracer.span("checkpoint", step=step), ledger.measure("checkpoint"):
                self._save_with_stamp(step, state)
            last_saved, t_last_ckpt = step, time.perf_counter()

        try:
            for step in range(start_step, num_steps):
                if feeder is not None:
                    with tracer.span("batch_wait", step=step + 1), ledger.measure("input_wait"):
                        try:
                            placed = next(feeder)
                        except StopIteration:
                            break
                else:
                    with tracer.span("batch_fetch", step=step + 1), ledger.measure("input_wait"):
                        try:
                            batch = next(train_iter)
                        except StopIteration:
                            break
                    telemetry.observe(batch)
                    with tracer.span("shard_batch", step=step + 1), ledger.measure("h2d"):
                        placed = self.shard_batch(batch)
                    del batch
                telemetry.before_step(step, state)
                t_step = time.perf_counter()
                with tracer.span("step_dispatch", step=step + 1):
                    state, metrics = self.train_step_placed(state, placed)
                del placed
                telemetry.after_step(step, time.perf_counter() - t_step)
                if cfg.debug_nans:
                    # Before the log boundary, so a nonfinite state is
                    # never saved.
                    assert_all_finite(metrics, f"metrics at step {step + 1}")
                window.append(metrics)
                timed += 1
                if (step + 1) % cfg.log_every_steps == 0 or step + 1 == num_steps:
                    record = close_window(step + 1, last=step + 1 == num_steps)
                    now = time.perf_counter()
                    telemetry.log_boundary(step + 1, record)
                    if self.checkpointer is not None and state.step != last_saved:
                        since = state.step - (start_step if last_saved is None else last_saved)
                        due = (cfg.checkpoint_every_steps
                               and since >= cfg.checkpoint_every_steps) or (
                            cfg.checkpoint_every_secs is not None
                            and now - t_last_ckpt >= cfg.checkpoint_every_secs
                        )
                        if due:
                            save(state.step)
                if (step + 1) % spe == 0:
                    epoch = (step + 1) // spe
                    if eval_iter_fn is not None and epoch % cfg.eval_every_epochs == 0:
                        with tracer.span("eval", epoch=epoch), ledger.measure("eval"):
                            record = self.evaluate(state, eval_iter_fn())
                        record["step"] = step + 1
                        history.append(record)
                        if log_fn is not None:
                            log_fn(record)
                    if (self.checkpointer is not None and epoch % cfg.checkpoint_every_epochs == 0
                            and state.step != last_saved):
                        save(state.step)
                    t_last, timed = time.perf_counter(), 0
                telemetry.beat(step)
            if window:  # the feed ended before num_steps
                close_window(state.step, last=True)
            telemetry.stop_watchdog()
            if self.checkpointer is not None:
                if state.step != last_saved and state.step > start_step:
                    save(state.step)
                with ledger.measure("checkpoint"):
                    self.checkpointer.wait()
        finally:
            telemetry.close(sys.exc_info()[1], feeder)
            self.last_goodput = telemetry.goodput
            if feeder is not None:
                self.last_feeder_stats = telemetry.feeder_stats
        if feeder is not None:
            # The feed ended on a log boundary: its stats join the last
            # train record.
            trained = [r for r in history if "loss" in r]
            if trained and "feeder_batches" not in trained[-1]:
                trained[-1].update({f"feeder_{k}": v for k, v in self.last_feeder_stats.items()})
        return state, history

    def _kernel_note(self) -> dict:
        """The manifest's ``kernels`` note: the card, the attention kernels'
        launch counters in this process (on the card the two warm-ups and
        the capture of each step signature), and the captured step's
        launches, by variant, and replays (``fit`` adds the first step's
        end, ``first_step_unix``)."""
        note = {"device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                "launches": launch_counts()}
        graphs = self.train_graphs
        summary = graphs.summary() if graphs is not None else None
        if summary is not None:
            note.update({k: summary[k] for k in ("captured_launches", "captured_variants",
                                                  "replays", "capture_s")})
        return note


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
