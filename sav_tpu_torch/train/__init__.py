"""Training for the PyTorch port (mirrors ``sav_tpu/train``).

``python -m sav_tpu_torch.train`` is the command-line twin of ``train.py``
for what this slice carries (:func:`main`).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from sav_tpu_torch.train.config import TrainConfig
from sav_tpu_torch.train.state import TrainState
from sav_tpu_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "TrainState", "Trainer", "main"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sav_tpu_torch.train",
        description="Train a sav_tpu_torch model on synthetic or fake data "
        "(the flags of train.py that the port carries).",
    )
    data = p.add_mutually_exclusive_group(required=True)
    data.add_argument("--fake-data", action="store_true", help="Zero batches, no real data.")
    data.add_argument(
        "--synth-data", action="store_true",
        help="Deterministic learnable synthetic batches (class id as a brightness offset).",
    )
    p.add_argument("-m", "--model-name", default="deit_s_patch16")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=1024, help="Global batch size.")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--steps", type=int, default=None, help="Override total steps.")
    p.add_argument("--learning-rate", type=float, default=5e-4, help="Base LR (×bs/512).")
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--log-every-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    return p


def main(argv: Optional[list] = None) -> dict:
    """Parse ``argv``, train, print one JSON line of the final metrics and
    return it."""
    from sav_tpu_torch.data.synthetic import fake_data_iterator, synth_resumable_iterator

    args = _parser().parse_args(argv)
    config = TrainConfig(
        model_name=args.model_name,
        num_classes=args.num_classes,
        image_size=args.image_size,
        compute_dtype=args.dtype,
        global_batch_size=args.batch_size,
        base_lr=args.learning_rate,
        warmup_epochs=args.warmup_epochs,
        log_every_steps=args.log_every_steps,
        seed=args.seed,
        # Synthetic batches come NHWC; the fake pipeline ships HWCN.
        transpose_images=not args.synth_data,
    )
    trainer = Trainer(config, device=args.device)
    if args.synth_data:
        batches = synth_resumable_iterator(
            seed=args.seed, batch_size=args.batch_size,
            image_size=args.image_size, num_classes=args.num_classes,
        )
    else:
        batches = fake_data_iterator(
            batch_size=args.batch_size, image_size=args.image_size,
            num_classes=args.num_classes, transpose=config.transpose_images,
        )
    state, history = trainer.fit(batches, num_steps=args.steps)
    final = {"step": state.step, "device": str(trainer.device), **history[-1]} if history else {
        "step": state.step, "device": str(trainer.device)}
    print(json.dumps(final), flush=True)
    return final
