"""Named experiment presets (the port's own copy of ``sav_tpu/train/presets.py``).

Every preset ``sav_tpu`` registers, with the same fields, as
:class:`~sav_tpu_torch.train.config.TrainConfig` constructors. A preset (or
an override) that sets a field the port does not carry yet raises the
``NotImplementedError`` ``TrainConfig`` raises; a preset whose model family
is not ported builds its config, and ``create_model`` refuses the model,
naming its ROADMAP item.

Usage::

    config = get_preset("botnet_t3_imagenet", checkpoint_dir="ckpt")
    Trainer(config).fit(...)
"""

from __future__ import annotations

import dataclasses
from typing import Any

from sav_tpu_torch.train.config import TrainConfig

_PRESETS: dict = {}


def register_preset(name: str, **kwargs: Any) -> None:
    _PRESETS[name] = kwargs


def preset_names() -> list:
    return sorted(_PRESETS)


def get_preset(name: str, **overrides: Any) -> TrainConfig:
    """Build the named TrainConfig, with field overrides applied on top."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {', '.join(preset_names())}")
    kwargs = dict(_PRESETS[name])
    kwargs.update(overrides)
    valid = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(kwargs) - valid
    if unknown:
        raise TypeError(f"invalid TrainConfig fields for preset {name}: {unknown}")
    return TrainConfig(**kwargs)


# --------------------------------------------------------------- ImageNet-1k

# The reference's one concrete experiment config: absolute peak lr 1e-3 at
# batch 2048, expressed through divisor = batch size.
register_preset(
    "botnet_t3_imagenet",
    model_name="botnet_t3",
    global_batch_size=2048,
    num_epochs=300,
    base_lr=1e-3,
    lr_scaling_divisor=2048,
    warmup_epochs=5,
    weight_decay=0.05,
    label_smoothing=0.1,
    augment="cutmix_mixup_randaugment_405",
    compute_dtype="bfloat16",
)

# DeiT-S/16, the DeiT recipe: batch 1024, lr 5e-4 × batch/512, 300 epochs.
register_preset(
    "deit_s_imagenet",
    model_name="deit_s_patch16",
    global_batch_size=1024,
    num_epochs=300,
    base_lr=5e-4,
    lr_scaling_divisor=512,
    warmup_epochs=5,
    weight_decay=0.05,
    label_smoothing=0.1,
    augment="cutmix_mixup_randaugment_405",
    compute_dtype="bfloat16",
)

register_preset(
    "vit_b_imagenet",
    model_name="vit_b_patch16",
    global_batch_size=1024,
    num_epochs=300,
    base_lr=5e-4,
    lr_scaling_divisor=512,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
)

register_preset(
    "cait_s24_imagenet",
    model_name="cait_s_24",
    global_batch_size=1024,
    num_epochs=300,
    base_lr=5e-4,
    lr_scaling_divisor=512,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
)

register_preset(
    "cvt_13_imagenet",
    model_name="cvt-13",
    global_batch_size=2048,
    num_epochs=300,
    base_lr=1e-3,
    lr_scaling_divisor=2048,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
)

register_preset(
    "tnt_s_imagenet",
    model_name="tnt_s_patch16",
    global_batch_size=1024,
    num_epochs=300,
    base_lr=5e-4,
    lr_scaling_divisor=512,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
)

register_preset(
    "ceit_s_imagenet",
    model_name="ceit_s",
    global_batch_size=1024,
    num_epochs=300,
    base_lr=5e-4,
    lr_scaling_divisor=512,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
)

register_preset(
    "mixer_b_imagenet",
    model_name="mixer_b_patch16",
    global_batch_size=4096,
    num_epochs=300,
    base_lr=1e-3,
    lr_scaling_divisor=4096,
    weight_decay=0.1,
    augment="cutmix_mixup_randaugment_405",
)

# ------------------------------------------------------------ smoke configs

# A small CPU-runnable slice.
register_preset(
    "vit_ti_cifar_smoke",
    model_name="vit_ti_patch16",
    num_classes=10,
    image_size=32,
    compute_dtype="float32",
    global_batch_size=64,
    num_train_images=50_000,
    num_epochs=2,
    warmup_epochs=1,
    transpose_images=False,
    augment="",
)

# Kill-and-resume smoke: a 2-layer ViT that restarts in seconds on a CPU,
# f32 so resumed loss curves compare bit for bit, 1000-step epochs and a
# log every 2 steps. Pair with --synth-data --checkpoint-every-steps N.
register_preset(
    "elastic_smoke",
    model_name="vit_ti_patch16",
    model_overrides=dict(num_layers=2, embed_dim=64, num_heads=4),
    num_classes=10,
    image_size=32,
    compute_dtype="float32",
    global_batch_size=8,
    num_train_images=8 * 1000,
    num_epochs=1,
    warmup_epochs=0,
    base_lr=1e-3,
    lr_scaling_divisor=8,
    transpose_images=False,
    augment="",
    log_every_steps=2,
    seed=0,
)

# The digits recipe (scikit-learn digits as 48² ImageNet-layout records).
register_preset(
    "vit_ti_digits",
    model_name="vit_ti_patch16",
    num_classes=10,
    image_size=48,
    global_batch_size=128,
    num_train_images=1438,
    num_epochs=150,
    warmup_epochs=10,
    base_lr=2e-3,
    augment="cutmix_mixup",
    transpose_images=False,
    seed=42,
)

# Per-family digits recipes: each family cut in depth to the 1.4k-image 48²
# dataset, widths and mechanisms kept.
_DIGITS_RECIPE = dict(
    num_classes=10,
    image_size=48,
    global_batch_size=128,
    num_train_images=1438,
    num_epochs=150,
    warmup_epochs=10,
    base_lr=2e-3,
    augment="cutmix_mixup",
    transpose_images=False,
    seed=42,
)

register_preset(
    "cait_digits",
    model_name="cait_xxs_24",
    model_overrides=dict(
        num_layers=6,
        num_layers_token_only=2,
        patch_shape=(8, 8),
        stoch_depth_rate=0.05,
    ),
    **_DIGITS_RECIPE,
)
register_preset(
    "cvt_digits",
    model_name="cvt-13",
    model_overrides=dict(num_layers=(1, 1, 2)),
    **_DIGITS_RECIPE,
)
register_preset(
    "botnet_digits",
    model_name="botnet_t3",
    model_overrides=dict(stage_sizes=(1, 1, 2, 1)),
    **_DIGITS_RECIPE,
)
register_preset(
    "tnt_digits",
    model_name="tnt_s_patch16",
    model_overrides=dict(num_layers=4, patch_shape=(8, 8)),
    **_DIGITS_RECIPE,
)
register_preset(
    "ceit_digits",
    model_name="ceit_t",
    model_overrides=dict(num_layers=4),
    **_DIGITS_RECIPE,
)
register_preset(
    "mixer_digits",
    model_name="mixer_s_patch32",
    model_overrides=dict(num_layers=6, patch_shape=(8, 8)),
    **_DIGITS_RECIPE,
)

# The digits recipe with RandAugment at 2 layers, magnitude 1.
register_preset(
    "vit_ti_digits_ra",
    model_name="vit_ti_patch16",
    **{**_DIGITS_RECIPE, "augment": "cutmix_mixup_randaugment_201"},
)

# ------------------------------------------------- full-scale dress rehearsal

# The production configuration (DeiT-S, 1000 classes, 224², bf16, the full
# augmentation) on a synthetic label-derived dataset, ~560 steps at 256.
register_preset(
    "deit_s_rehearsal",
    model_name="deit_s_patch16",
    num_classes=1000,
    image_size=224,
    compute_dtype="bfloat16",
    global_batch_size=256,
    num_train_images=2048,
    num_epochs=70,
    warmup_epochs=5,
    base_lr=5e-4,
    weight_decay=0.05,
    augment="cutmix_mixup_randaugment_405",
    transpose_images=False,
    eval_every_epochs=10,
    checkpoint_every_epochs=10,
    log_every_steps=8,
    seed=0,
)
