"""Train-throughput benchmark of the port: ``python -m sav_tpu_torch.train.bench``.

The port's twin of ``bench.py``: the full train step (forward, backward,
AdamW, bf16 compute, label smoothing) of one model at one batch on one
card, through the trainer's own entry points (``shard_batch``,
``compile_train_step``, ``train_step_placed``): on the card a captured
CUDA graph per step. It prints exactly one JSON line:

- ``value``: the best window's images/s (the least step time is what the
  hardware can do; a shared host shows transient slowdowns), beside
  ``median_img_per_sec`` and ``step_ms`` (the best window's ms per step);
- ``mfu``: the analytic step FLOPs (:mod:`sav_tpu_torch.obs.costs`) over
  the best step time over the card's peak, with ``peak_flops`` and
  ``peak_source``; for a family the cost model would count wrong (CeiT,
  CvT, TNT, MLP-Mixer) ``mfu`` and ``step_flops`` are null and
  ``cost_source`` says why;
- ``transfer_bytes_per_batch``: the bytes a batch moves to the card:
  uint8 with ``--device-preprocess`` (the step mixes and normalises on the
  card), bf16 without, so the first is half the second;
- ``capture_s`` and ``captured_launches`` (the kernels one replay runs),
  ``replays`` (counted where each replay is launched: the two warm-up
  steps and the windows' steps) with ``replayed_launches`` (replays ×
  captured), the feeder's counters, ``platform`` and the card's name and
  power limit as ``nvidia-smi`` gives them;
- ``outcome``: ``"ok"``, or ``"nonfinite"`` when a window's loss is not
  finite: the number is then not a measurement.

Feed (``--feed``): ``synthetic`` cycles a pool of two host batches made
from seed 0 and places each step's batch through the trainer's feed: the
async :class:`~sav_tpu_torch.data.feeder.DeviceFeeder` (pinned memory, a
stream of its own, overlapping the step), or serially with
``--no-async-feed``. ``pipeline`` and ``savrec`` need the host input
pipeline and the native record loader, which are not ported (ROADMAP
queue A6). ``--backend`` takes bench.py's choices; its default here is the
port's ``auto`` dispatch (the kernels), where bench.py's is the dense
path. ``--device cpu`` runs it on the CPU, for tests at a toy size.

Usage (on the card):
  python -m sav_tpu_torch.train.bench --model deit_s_patch16 --batch-size 256
  python -m sav_tpu_torch.train.bench --device-preprocess
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

AUGMENT = "cutmix_mixup_randaugment_405"


def _host_batches(batch_size: int, image_size: int, num_classes: int,
                  device_preprocess: bool) -> list:
    """Two host batches from seed 0: post-augment uint8 NHWC images for
    ``device_preprocess``, else normalised bf16 ones (the late-bf16 wire
    format), with int32 labels."""
    from sav_tpu_torch.ops.preprocess import normalize_images

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        images = torch.from_numpy(
            rng.integers(0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8))
        if not device_preprocess:
            images = normalize_images(images, torch.bfloat16)
        labels = rng.integers(0, num_classes, (batch_size,), dtype=np.int32)
        batches.append({"images": images, "labels": labels})
    return batches


def run(args: argparse.Namespace) -> dict:
    from sav_tpu_torch.data.feeder import DeviceFeeder
    from sav_tpu_torch.obs.costs import (
        analytic_cost_refusal,
        has_analytic_cost,
        resolve_peak_flops,
        train_step_cost,
    )
    from sav_tpu_torch.train import TrainConfig, Trainer
    from sav_tpu_torch.utils.device import card

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    config = TrainConfig(
        model_name=args.model, num_classes=args.num_classes, image_size=args.image_size,
        compute_dtype="bfloat16",
        attention_backend=None if args.backend == "auto" else args.backend,
        global_batch_size=args.batch_size, transpose_images=False, clip_grad_norm=1.0,
        device_preprocess=args.device_preprocess, async_feed=not args.no_async_feed,
        augment=AUGMENT, seed=0, model_overrides=args.model_overrides,
    )
    trainer = Trainer(config, device=str(device))
    # Decided before the windows run: a family the cost model would count
    # wrong still gets its line, without an MFU.
    cost = (train_step_cost(trainer.model, batch_size=args.batch_size,
                            image_size=args.image_size)
            if has_analytic_cost(trainer.model) else None)
    state = trainer.init_state()
    batches = _host_batches(args.batch_size, args.image_size, args.num_classes,
                            args.device_preprocess)
    transfer_bytes = sum(torch.as_tensor(v).numel() * torch.as_tensor(v).element_size()
                         for v in batches[0].values())
    source = itertools.cycle(batches)
    feeder = (DeviceFeeder(source, trainer.shard_batch, depth=config.feed_depth,
                           name="bench-feeder") if config.async_feed else None)

    def next_placed():
        return next(feeder) if feeder is not None else trainer.shard_batch(next(source))

    def sync(metrics) -> float:
        return float(metrics["loss"])  # one device-to-host copy: waits for the step

    try:
        t0 = time.perf_counter()
        step = trainer.compile_train_step(state, next_placed())
        compile_s = time.perf_counter() - t0
        for _ in range(2):  # warm-up replays
            state, metrics = step(state, next_placed())
        sync(metrics)
        windows, losses = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, metrics = step(state, next_placed())
            losses.append(sync(metrics))
            windows.append((time.perf_counter() - t0) / args.steps)
    finally:
        feeder_stats = feeder.stats() if feeder is not None else None
        if feeder is not None:
            feeder.close()
    best = min(windows)
    # What the replays ran, counted where each replay is launched (none on
    # the CPU, where every step runs eagerly).
    graphs = trainer.train_graphs
    replays = graphs.summary()["replays"] if graphs is not None else 0
    peak, peak_source = resolve_peak_flops(args.peak_flops, device)
    smi = card() if device.type == "cuda" else None
    feed = "synthetic" + (" uint8+device-preprocess" if args.device_preprocess else " bf16")
    feed += "" if config.async_feed else " serial"
    return {
        "metric": f"{args.model} train img/s (bs={args.batch_size}, bf16, {args.backend} "
                  f"attention, {feed} feed, 1 card, best of {args.reps}x{args.steps}-step "
                  "windows)",
        "value": round(args.batch_size / best, 1),
        "unit": "img/s",
        "median_img_per_sec": round(args.batch_size / statistics.median(windows), 1),
        "step_ms": round(best * 1e3, 3),
        "window_step_ms": [round(w * 1e3, 3) for w in windows],
        "mfu": round(cost.flops / best / peak, 4) if peak and cost else None,
        "step_flops": cost.flops if cost else None,
        "cost_source": cost.source if cost else f"none: {analytic_cost_refusal(trainer.model)}",
        "flops_attribution": ({k: round(v, 4) for k, v in cost.attribution.items()}
                              if cost else None),
        "peak_flops": peak,
        "peak_source": peak_source,
        "transfer_bytes_per_batch": transfer_bytes,
        "compile_s": round(compile_s, 3),
        "capture_s": round(step.capture_s, 3),
        "captured_launches": {k: v for k, v in step.captured_launches.items() if v},
        "captured_variants": {k: {v: n for v, n in by.items() if n}
                              for k, by in step.captured_variants.items() if any(by.values())},
        "replays": replays,
        "replayed_launches": ({k: v for k, v in graphs.total_launches().items() if v}
                              if graphs is not None else {}),
        "replayed_variants": ({k: {v: n for v, n in by.items() if n}
                               for k, by in graphs.total_variants().items() if any(by.values())}
                              if graphs is not None else {}),
        "feeder": feeder_stats,
        "window_losses": losses,
        "platform": device.type,
        "card": smi,
        "outcome": "ok" if all(math.isfinite(x) for x in losses) else "nonfinite",
    }


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sav_tpu_torch.train.bench",
        description="Train throughput of one sav_tpu_torch model on one card "
        "(the twin of bench.py); prints one JSON line.",
    )
    p.add_argument("--model", default="deit_s_patch16")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20, help="Steps per timed window.")
    p.add_argument("--reps", type=int, default=4,
                   help="Timed windows; the best and the median are both reported.")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--backend", default="auto", choices=["xla", "fused", "pallas", "auto"],
                   help="Attention backend: auto (the port's dispatch rule: the kernels), "
                   "fused, pallas (the flash kernels) or xla (the dense path).")
    p.add_argument("--feed", default="synthetic", choices=["synthetic", "pipeline", "savrec"],
                   help="synthetic: two seeded host batches, placed every step.")
    p.add_argument("--device-preprocess", action="store_true",
                   help="Ship post-augment uint8 (half the bf16 bytes); the captured step "
                   f"mixes ({AUGMENT}) and normalises on the card.")
    p.add_argument("--no-async-feed", action="store_true",
                   help="Place each batch on the training thread instead of the feeder's.")
    p.add_argument("--peak-flops", type=float, default=None,
                   help="Peak FLOP/s override for the MFU (default: the card's table row).")
    p.add_argument("--model-overrides", type=json.loads, default=None,
                   help="Extra create_model arguments as JSON, e.g. '{\"num_layers\": 2}'.")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    return p


def main(argv: Optional[list] = None) -> dict:
    """Parse ``argv``, run, print one JSON line and return it."""
    parser = _parser()
    args = parser.parse_args(argv)
    if args.feed != "synthetic":
        parser.error(f"--feed {args.feed} needs the host input pipeline and the native record "
                     "loader, which are not ported yet: ROADMAP queue A6")
    result = run(args)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
