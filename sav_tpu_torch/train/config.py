"""Typed training configuration (the port's own copy of
``sav_tpu/train/config.py``).

Every field of ``sav_tpu``'s ``TrainConfig`` exists here with its name and
default, so a config serialised by either side loads in the other. The
fields this slice carries take any value; every other field is accepted
only at its default, and any other value raises ``NotImplementedError``
naming the ROADMAP item that will carry it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from sav_tpu_torch.utils.device import COMPUTE_DTYPES

# Fields the port does not carry yet, and the ROADMAP item each waits on.
_NOT_CARRIED = {
    # sav_tpu's tune cache holds TPU measurements; the port's crossovers
    # are to be measured on the card.
    "attention_tune_cache": "queue B follow-up 4 (auto's crossovers, measured on the card)",
    # A CUDA graph lives in its process: there is nothing to write to disk.
    "compilation_cache_dir": "queue A10 (infra; a captured CUDA graph cannot be cached on disk)",
    "mesh_axes": "queue A9 (parallelism)",
    "layout_preset": "queue A9 (parallelism)",
    "sequence_parallel": "queue A9 (parallelism)",
    "pipeline_parallel": "queue A9 (parallelism)",
    "pipeline_microbatches": "queue A9 (parallelism)",
    **{
        name: "queue A10 (observability)"
        for name in (
            "profile_dir", "profile_start_step", "profile_num_steps",
            "diagnostics", "autoprof", "autoprof_steps", "autoprof_max",
            "peak_flops", "memdump", "sanitize",
        )
    },
}


@dataclasses.dataclass
class TrainConfig:
    # Model
    model_name: str = "deit_s_patch16"
    num_classes: int = 1000
    image_size: int = 224
    compute_dtype: str = "bfloat16"
    # None = the port's auto rule (the fused kernels wherever the forward
    # and the backward fit, else the flash kernels) | 'fused' | 'pallas'
    # (the flash kernels) | 'xla'.
    attention_backend: Optional[str] = None
    attention_tune_cache: Optional[str] = None
    # Softmax dtype of the 'xla' attention path; None = the compute dtype.
    attention_logits_dtype: Optional[str] = None
    # "int8": QAT, every projection, FF and head dot on the int8 arm
    # (sav_tpu_torch.ops.quant), its backward rounding the gradient with
    # the trainer's "quant" generator; None = the float path. The parameters
    # are the float arm's, so a QAT checkpoint serves through
    # ServeConfig.quant_weights.
    quant: Optional[str] = None
    # Extra create_model arguments (e.g. {'num_layers': 2}).
    model_overrides: Optional[dict] = None
    # Batches arrive as post-augment uint8; the train step applies the
    # augment string's mixes and normalises on the device.
    device_preprocess: bool = False
    # fit/evaluate place batches on a feeder thread, feed_depth ahead.
    async_feed: bool = True
    feed_depth: int = 2
    compilation_cache_dir: Optional[str] = None

    # Data. ``augment`` names the augmentation; the trainer reads its mixes
    # under device_preprocess and otherwise takes batches as given.
    global_batch_size: int = 1024
    num_train_images: int = 1_281_167  # ImageNet-1k train
    augment: str = "cutmix_mixup_randaugment_405"
    transpose_images: bool = True  # batches arrive HWCN; the trainer permutes

    # Optimization
    num_epochs: int = 300
    base_lr: float = 5e-4  # scaled by global_batch / lr_scaling_divisor
    lr_scaling_divisor: int = 512
    end_lr: float = 1e-5
    warmup_epochs: int = 5
    weight_decay: float = 0.05
    clip_grad_norm: Optional[float] = 1.0
    # optax.flatten in sav_tpu; numerically nothing, so any value is taken.
    fused_optimizer: Optional[bool] = None
    label_smoothing: float = 0.1
    ema_decay: Optional[float] = None
    # Times the sum of the sown losses (the MoE blocks' balance and router
    # z-losses) added to the cross entropy; 0 for a model that sows none.
    aux_loss_weight: float = 0.01
    grad_accum_steps: int = 1
    seed: int = 42

    # Mesh and parallelism
    mesh_axes: Optional[dict] = None
    layout_preset: Optional[str] = None
    sequence_parallel: Optional[str] = None
    pipeline_parallel: Optional[int] = None
    pipeline_microbatches: int = 8

    # Logging and checkpointing
    eval_every_epochs: int = 5
    checkpoint_every_epochs: int = 10
    checkpoint_every_steps: Optional[int] = None
    checkpoint_every_secs: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    log_every_steps: int = 100

    # Observability
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    debug_nans: bool = False
    log_dir: Optional[str] = None
    diagnostics: bool = False
    trace_spans: bool = False
    watchdog_secs: Optional[float] = None
    watchdog_soft_secs: Optional[float] = None
    fleet: bool = True
    autoprof: bool = False
    autoprof_steps: int = 4
    autoprof_max: int = 2
    peak_flops: Optional[float] = None
    record: bool = False
    record_depth: int = 16
    record_batches: int = 4
    record_snapshot_every: Optional[int] = None
    spike_sigma: float = 6.0
    memdump: bool = True
    sanitize: bool = False

    def __post_init__(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, item in _NOT_CARRIED.items():
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"TrainConfig.{name}={value!r} is not ported yet (only its "
                    f"default {defaults[name]!r} is): ROADMAP {item}"
                )
        if self.quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {self.quant!r}")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        if self.feed_depth < 1:
            raise ValueError(f"feed_depth must be >= 1, got {self.feed_depth}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {self.compute_dtype!r}"
            )

    @property
    def steps_per_epoch(self) -> int:
        return self.num_train_images // self.global_batch_size

    @property
    def total_steps(self) -> int:
        return self.steps_per_epoch * self.num_epochs

    @property
    def learning_rate(self) -> float:
        return self.base_lr * self.global_batch_size / self.lr_scaling_divisor

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))
