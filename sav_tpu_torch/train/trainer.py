"""Single-device trainer (port of ``sav_tpu/train/trainer.py``).

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
backward pass. Stochastic depth and dropout draw their masks from two
generators on the device, used by nothing else (``sav_tpu``'s
``'stochastic_depth'`` and ``'dropout'`` streams): the first seeded from
``config.seed``, the second from a seed derived from it
(:func:`stream_seed`). Their states are part of the train state and of
every checkpoint, so a restored run draws the masks the uninterrupted run
would have drawn. The step is ``sav_tpu``'s ``_train_step_impl``: one-hot
f32 labels (mixed by ``mix_labels``/``ratio`` when the batch has them),
label smoothing, f32 cross entropy, backward, the masked AdamW of
:mod:`sav_tpu_torch.train.optimizer`; with ``grad_accum_steps > 1`` the
batch is split into micro-batches whose f32 gradients are averaged before
one update (BatchNorm statistics thread through them in order).

Metrics stay on the device as 0-d tensors; :meth:`Trainer.fit` brings a log
window's metrics to the host in one copy, and saves checkpoints
(:mod:`sav_tpu_torch.train.checkpoint`) and evaluates at the cadences the
config sets. Without a card the trainer refuses to run unless the caller
passes ``device="cpu"``.

Not ported yet (ROADMAP queue A4/A6/A9/A10): the supervisor, the async
device feed, on-device mixing, meshes and the telemetry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import set_dropout_generator, set_stochastic_depth_generator
from sav_tpu_torch.models.surgery import adapt_pos_embeds
from sav_tpu_torch.train.checkpoint import Checkpointer
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

_EVAL_KEYS = ("loss_sum", "top_1_sum", "top_5_sum", "count")


def stream_seed(seed: int, stream: str) -> int:
    """The seed of a named generator stream derived from the run's ``seed``:
    the first 8 bytes of ``sha256(f"{seed}/{stream}")``, so no stream shares
    a seed with another run's."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{stream}".encode()).digest()[:8], "little")


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
                **(config.model_overrides or {}),
            )
        self.model = model.to(device=self.device, dtype=torch.float32)
        self.generators = {
            "stochastic_depth": torch.Generator(device=self.device),
            "dropout": torch.Generator(device=self.device),
        }
        self._seed_generators()
        set_stochastic_depth_generator(self.model, self.generators["stochastic_depth"])
        set_dropout_generator(self.model, self.generators["dropout"])
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

    def _seed_generators(self) -> None:
        seed = self.config.seed
        self.generators["stochastic_depth"].manual_seed(seed)
        self.generators["dropout"].manual_seed(stream_seed(seed, "dropout"))

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
                          batch_stats=dict(self.model.named_buffers()),
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
        schedule's learning rate as a float).

        With ``grad_accum_steps`` > 1 the batch is split into that many
        micro-batches, run in order (each BatchNorm normalises by its
        micro-batch and updates the running statistics the next one sees,
        as ``sav_tpu``'s scan carries them); their f32 gradients are summed
        and divided by the count, the loss is the micro-batches' mean, the
        top-k metrics are taken on their concatenated logits, and the one
        update and ``grad_norm`` use the averaged gradients."""
        model = state.model
        model.train()
        images = self._prep_images(batch["images"])
        labels = self._labels(batch)
        label_probs = self._label_probs(batch, labels)
        params = list(model.parameters())
        accum = self.config.grad_accum_steps
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum_steps {accum}")
        aux_loss = torch.zeros((), device=self.device)  # ViT sows no auxiliary loss
        grads, loss, logits = None, None, []
        for micro_images, micro_probs in zip(images.split(b // accum),
                                             label_probs.split(b // accum)):
            micro_logits = model(micro_images)
            micro_loss = (cross_entropy(micro_logits, micro_probs)
                          + self.config.aux_loss_weight * aux_loss)
            micro_grads = torch.autograd.grad(micro_loss, params)
            if grads is None:
                grads, loss = list(micro_grads), micro_loss.detach()
            else:
                torch._foreach_add_(grads, micro_grads)
                loss = loss + micro_loss.detach()
            logits.append(micro_logits.detach())
        if accum > 1:
            torch._foreach_div_(grads, accum)
            loss = loss / accum
        with torch.no_grad():
            grad_norm = global_norm(grads)  # before the clip, as sav_tpu logs it
            opt_state = self.tx.step(
                params, grads, self._decay_mask, state.opt_state, grad_norm=grad_norm
            )
            acc = topk_correct(torch.cat(logits).float(), labels)
        metrics = {
            "loss": loss,
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
        size; a shorter batch is padded (:meth:`_pad_eval_batch`). The
        per-batch sums stay on the device and reach the host in one copy at
        the end; the host runs at most ``feed_depth + 1`` batches ahead of
        the device (each batch in flight holds its inputs there)."""
        batch_size: Optional[int] = None
        sums, fences = [], []
        max_inflight = self.config.feed_depth + 1
        retired = 0
        for batch in eval_iter:
            n = len(batch["labels"])
            if batch_size is None:
                batch_size = n
            if n < batch_size:
                batch = self._pad_eval_batch(batch, batch_size)
            step_sums = self.eval_step(state, batch)
            sums.append(torch.stack([step_sums[k] for k in _EVAL_KEYS]))
            if self.device.type == "cuda":
                fences.append(torch.cuda.Event())
                fences[-1].record()
                if len(fences) - retired >= max_inflight:
                    fences[retired].synchronize()
                    retired += 1
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
                    "manual_seed(stream_seed(seed, 'dropout')) for 'dropout'; both "
                    "resume from the states saved in generators.pt",
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
    ):
        """Train from ``state`` (default :meth:`restore_or_init`) up to step
        ``num_steps`` in all (default ``config.total_steps``): the loop runs
        from ``state.step``, and stops early when ``train_iter`` ends (closing
        the log window there).

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
        writes are waited for. Returns ``(state, history)``."""
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

        def close_window() -> float:
            nonlocal window, t_last, timed
            records = _to_host(window)
            now = time.perf_counter()
            step_s = (now - t_last) / max(timed, 1)
            for offset, record in enumerate(records):
                record["step"] = state.step - len(records) + offset + 1
            records[-1]["step_s"] = step_s
            records[-1]["images_per_sec"] = cfg.global_batch_size / step_s
            history.extend(records)
            if log_fn is not None:
                log_fn(records[-1])
            window, t_last, timed = [], now, 0
            return now

        for step in range(start_step, num_steps):
            try:
                batch = next(train_iter)
            except StopIteration:
                break
            state, metrics = self.train_step(state, batch)
            window.append(metrics)
            timed += 1
            if (step + 1) % cfg.log_every_steps == 0 or step + 1 == num_steps:
                now = close_window()
                if self.checkpointer is not None and state.step != last_saved:
                    since = state.step - (start_step if last_saved is None else last_saved)
                    due = (cfg.checkpoint_every_steps and since >= cfg.checkpoint_every_steps) or (
                        cfg.checkpoint_every_secs is not None
                        and now - t_last_ckpt >= cfg.checkpoint_every_secs
                    )
                    if due:
                        self._save_with_stamp(state.step, state)
                        last_saved, t_last_ckpt = state.step, time.perf_counter()
            if (step + 1) % spe == 0:
                epoch = (step + 1) // spe
                if eval_iter_fn is not None and epoch % cfg.eval_every_epochs == 0:
                    record = self.evaluate(state, eval_iter_fn())
                    record["step"] = step + 1
                    history.append(record)
                    if log_fn is not None:
                        log_fn(record)
                if (self.checkpointer is not None and epoch % cfg.checkpoint_every_epochs == 0
                        and state.step != last_saved):
                    self._save_with_stamp(state.step, state)
                    last_saved, t_last_ckpt = state.step, time.perf_counter()
                t_last, timed = time.perf_counter(), 0
        if window:  # the feed ended before num_steps
            close_window()
        if self.checkpointer is not None:
            if state.step != last_saved and state.step > start_step:
                self._save_with_stamp(state.step, state)
            self.checkpointer.wait()
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
