"""Training for the PyTorch port (mirrors ``sav_tpu/train``).

``python -m sav_tpu_torch.train`` is the command-line twin of ``train.py``
for what this slice carries (:func:`main`).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from sav_tpu_torch.train.checkpoint import Checkpointer
from sav_tpu_torch.train.config import TrainConfig
from sav_tpu_torch.train.presets import get_preset, preset_names
from sav_tpu_torch.train.state import TrainState
from sav_tpu_torch.train.trainer import Trainer

__all__ = ["Checkpointer", "TrainConfig", "TrainState", "Trainer", "get_preset", "main",
           "preset_names"]

# Flag → TrainConfig field. A flag left out keeps the preset's value, or
# TrainConfig's default without a preset.
_FLAG_TO_FIELD = {
    "model_name": "model_name", "num_classes": "num_classes", "image_size": "image_size",
    "dtype": "compute_dtype", "batch_size": "global_batch_size",
    "learning_rate": "base_lr", "warmup_epochs": "warmup_epochs",
    "log_every_steps": "log_every_steps", "seed": "seed",
    "checkpoint_dir": "checkpoint_dir", "checkpoint_every_steps": "checkpoint_every_steps",
    "checkpoint_every_secs": "checkpoint_every_secs", "grad_accum": "grad_accum_steps",
    "ema_decay": "ema_decay",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sav_tpu_torch.train",
        description="Train a sav_tpu_torch model on synthetic or fake data "
        "(the flags of train.py that the port carries). Flags given override "
        "the preset; the others keep its values (or TrainConfig's defaults).",
    )
    data = p.add_mutually_exclusive_group(required=True)
    data.add_argument("--fake-data", action="store_true", help="Zero batches, no real data.")
    data.add_argument(
        "--synth-data", action="store_true",
        help="Deterministic learnable synthetic batches (class id as a brightness offset), "
        "a pure function of the step: a resumed run reads the batches an "
        "uninterrupted run would.",
    )
    p.add_argument("--preset", choices=preset_names(), default=None,
                   help="Named experiment preset (sav_tpu_torch.train.presets).")
    p.add_argument("-m", "--model-name")
    p.add_argument("--num-classes", type=int)
    p.add_argument("--image-size", type=int)
    p.add_argument("--batch-size", type=int, help="Global batch size.")
    p.add_argument("--dtype", choices=["bfloat16", "float32"])
    p.add_argument("--steps", type=int, default=None, help="Override total steps.")
    p.add_argument("--learning-rate", type=float, help="Base LR (×bs/lr_scaling_divisor).")
    p.add_argument("--warmup-epochs", type=int)
    p.add_argument("--log-every-steps", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--grad-accum", type=int, help="Micro-batches per optimizer update.")
    p.add_argument("--ema-decay", type=float,
                   help="Parameter EMA decay (e.g. 0.9999); eval then runs on the averaged weights.")
    p.add_argument("-c", "--checkpoint-dir",
                   help="Checkpoint directory: the run resumes from its newest step.")
    p.add_argument("--checkpoint-every-steps", type=int,
                   help="Save once this many steps passed since the last save (at a log boundary).")
    p.add_argument("--checkpoint-every-secs", type=float,
                   help="Save once this many seconds passed since the last save (at a log boundary).")
    p.add_argument("--init-from",
                   help="Warm-start params/batch_stats from another run's checkpoint directory "
                   "(fresh step and optimizer; position tables resampled). A resumable "
                   "checkpoint in --checkpoint-dir wins.")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    return p


def main(argv: Optional[list] = None) -> dict:
    """Parse ``argv``, train, print one JSON line of the final metrics and
    return it."""
    from sav_tpu_torch.data.synthetic import fake_data_iterator, synth_resumable_iterator

    args = _parser().parse_args(argv)
    fields = {field: getattr(args, flag) for flag, field in _FLAG_TO_FIELD.items()
              if getattr(args, flag) is not None}
    # Synthetic batches come NHWC; the fake pipeline ships HWCN.
    fields["transpose_images"] = not args.synth_data
    config = get_preset(args.preset, **fields) if args.preset else TrainConfig(**fields)
    trainer = Trainer(config, device=args.device)
    # Restore before the data stream is built, so that it starts at the
    # restored step; a resumable checkpoint wins over --init-from.
    state = trainer.restore_or_init()
    if args.init_from and state.step == 0:
        state = trainer.warm_start_from(args.init_from)
    if args.synth_data:
        batches = synth_resumable_iterator(
            seed=config.seed, start_step=state.step, batch_size=config.global_batch_size,
            image_size=config.image_size, num_classes=config.num_classes,
        )
    else:
        batches = fake_data_iterator(
            batch_size=config.global_batch_size, image_size=config.image_size,
            num_classes=config.num_classes, transpose=config.transpose_images,
        )
    start_step = state.step
    state, history = trainer.fit(batches, num_steps=args.steps, state=state)
    if trainer.checkpointer is not None:
        trainer.checkpointer.close()
    final = {"step": state.step, "start_step": start_step, "device": str(trainer.device)}
    train_records = [r for r in history if "loss" in r]
    if train_records:
        final.update(train_records[-1])
    print(json.dumps(final), flush=True)
    return final
