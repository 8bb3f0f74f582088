"""Train-throughput benchmark of the port: ``python -m sav_tpu_torch.train.bench``.

The port's twin of ``bench.py``: the full train step (forward, backward,
AdamW, bf16 compute, label smoothing) of one model at one batch on one
card, through the trainer's own entry points (``shard_batch``,
``compile_train_step``, ``train_step_placed``): on the card a captured
CUDA graph per step. It prints exactly one JSON line:

- ``value``: with the synthetic feed the best window's images/s (the
  least step time is what the hardware can do; a shared host shows
  transient slowdowns); with a fed feed, which the host may set, the
  sustained rate: every window's images over every window's time. Beside
  it ``median_img_per_sec`` and ``step_ms`` (the ms per step ``value``
  stands for);
- ``mfu``: the analytic step FLOPs (:mod:`sav_tpu_torch.obs.costs`, each
  family's own count) over ``step_ms`` over the card's peak, with
  ``peak_flops`` and ``peak_source``; with ``--quant int8`` (QAT on the
  int8 arm) the peak is the card's int8 one (1,979 TOPS on an H100, named
  in ``peak_source``) and the line says ``"quant": "int8"`` (``null`` for
  the float arm): the card has no mixed peak, and the int8 dots carry
  ``int8_flops_share`` of the step's FLOPs;
- ``transfer_bytes_per_batch``: the bytes a batch moves to the card:
  uint8 with ``--device-preprocess`` (the step mixes and normalises on the
  card), bf16 without, so the first is half the second;
- ``capture_s`` and ``captured_launches`` (the kernels one replay runs),
  ``replays`` (counted where each replay is launched: the ``warmup_steps``
  and the windows' steps) with ``replayed_launches`` (replays ×
  captured), the feeder's counters, ``platform`` and the card's name and
  power limit as ``nvidia-smi`` gives them;
- ``outcome``: ``"ok"``, or ``"nonfinite"`` when a window's loss is not
  finite: the number is then not a measurement.

Feed (``--feed``), placed each step through the trainer's feed: the async
:class:`~sav_tpu_torch.data.feeder.DeviceFeeder` (pinned memory, a stream
of its own, overlapping the step), or serially with ``--no-async-feed``:

- ``synthetic`` cycles a pool of two host batches made from seed 0;
- ``pipeline`` runs the host input pipeline (:mod:`sav_tpu_torch.data.pipeline`)
  over max(4 × batch, 2,048) seeded images, JPEG-encoded in memory:
  decode, Inception crop, flip, bicubic resize, RandAugment and, without
  ``--device-preprocess``, the host mixes and the late bf16 cast;
- ``savrec`` reads a SavRecord file of as many seeded images
  (``bench.savrec`` in ``--work-dir``, written there when missing) through
  the native loader: gather, flip, normalize and bf16 cast, or uint8.

Before its windows a feed has batches in flight: made while the step
compiled, or while the feed was timed. A fed run drains them in its
warm-up (``warmup_steps``: two, plus the feeder's depth and the batch it
places, plus the batches the pipeline keeps submitted), so that its
windows run at the feed's pace. It also prints the feed's own rate
(``host_feed_img_per_sec``: max(steps, 10) batches drained from the feed
with no step, after the batches in flight and two more; the stream then
feeds the windows), the device's time for one step (``device_step_ms``:
10 replays of the captured step on one placed batch after one, timed with
CUDA events; ``device_timing_replays`` counts them among ``replays``) and
the share of the windows' time the device idled (``device_idle_share`` =
1 - device_step_ms / step_ms, unclamped: a negative share would say the
windows ran ahead of the device's own step; null on the CPU, which has no
device clock). ``--backend`` takes bench.py's
choices; its default here is the port's ``auto`` dispatch (the kernels),
where bench.py's is the dense path. ``--device cpu`` runs it on the CPU,
for tests at a toy size.

Usage (on the card):
  python -m sav_tpu_torch.train.bench --model deit_s_patch16 --batch-size 256
  python -m sav_tpu_torch.train.bench --device-preprocess
  python -m sav_tpu_torch.train.bench --quant int8
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
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


def _fed_iterator(args, work_dir: str):
    """A fresh host batch stream of ``--feed pipeline`` or ``savrec`` (module
    docstring), from seed 0."""
    rng = np.random.default_rng(0)
    n = max(4 * args.batch_size, 2048)
    if args.feed == "pipeline":
        from sav_tpu_torch.data.pipeline import Split, load

        images = rng.integers(0, 256, (n, args.image_size, args.image_size, 3), np.uint8)
        labels = rng.integers(0, args.num_classes, (n,), np.int64)
        return load(Split.TRAIN, source=(images, labels), is_training=True,
                    batch_dims=[args.batch_size], image_size=args.image_size,
                    augment_name=AUGMENT, bfloat16=True,
                    device_preprocess=args.device_preprocess, seed=0, process_index=0,
                    process_count=1)
    from sav_tpu_torch.data.records import SavRecDataset, savrec_train_iterator, write_savrec

    path = os.path.join(work_dir, "bench.savrec")
    if not os.path.exists(path):
        write_savrec(path,
                     rng.integers(0, 256, (n, args.image_size, args.image_size, 3), np.uint8),
                     rng.integers(0, args.num_classes, (n,), np.int32))
    return savrec_train_iterator(SavRecDataset(path), batch_size=args.batch_size, seed=0,
                                 normalize=not args.device_preprocess,
                                 bfloat16=not args.device_preprocess)


def _source_in_flight(feed: str) -> int:
    """Batches a fed stream may hold made ahead of the one it is asked for:
    the pipeline's submitted batches and the one it assembles; the
    SavRecord stream makes each batch when it is asked."""
    if feed == "pipeline":
        from sav_tpu_torch.data.pipeline import LOOKAHEAD

        return LOOKAHEAD + 1
    return 0


def _host_feed_rate(it, batch_size: int, warm: int, n: int) -> float:
    """Images per second of the feed alone: ``warm`` batches drained to
    start it and empty what it made ahead, then ``n`` timed with no step
    (the stream then feeds the windows)."""
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return batch_size * n / (time.perf_counter() - t0)


# Replays of the captured step on one placed batch that time the device's
# step for a fed line: one to warm, then the timed ones.
DEVICE_TIMING_ITERS = 10


def _device_step_ms(step, state, placed) -> float:
    """The device's time for one replay of the captured step on ``placed``
    (CUDA events over DEVICE_TIMING_ITERS replays, after one)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    state, _ = step(state, placed)
    start.record()
    for _ in range(DEVICE_TIMING_ITERS):
        state, _ = step(state, placed)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / DEVICE_TIMING_ITERS


def run(args: argparse.Namespace) -> dict:
    from sav_tpu_torch.obs.costs import int8_flops_share, resolve_peak_flops, train_step_cost
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
        # The savrec feed never mixes on the host, so its device_preprocess
        # step must not mix either (bench.py's pairing).
        augment="none" if args.feed == "savrec" else AUGMENT, seed=0,
        model_overrides=args.model_overrides, quant=args.quant,
    )
    trainer = Trainer(config, device=str(device))
    cost = train_step_cost(trainer.model, batch_size=args.batch_size,
                           image_size=args.image_size)
    state = trainer.init_state()
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="sav_bench_")
    host_rate, stream = None, None
    # Warm-up steps: two, and for a fed feed the batches in flight.
    warmup = 2
    try:
        if args.feed == "synthetic":
            batches = _host_batches(args.batch_size, args.image_size, args.num_classes,
                                    args.device_preprocess)
            source = itertools.cycle(batches)
            first = batches[0]
        else:
            stream = _fed_iterator(args, work_dir)
            in_flight = _source_in_flight(args.feed)
            host_rate = _host_feed_rate(stream, args.batch_size, warm=2 + in_flight,
                                        n=max(args.steps, 10))
            if config.async_feed:
                in_flight += config.feed_depth + 1
            warmup += in_flight
            first = next(stream)
            source = itertools.chain([first], stream)
        transfer_bytes = sum(torch.as_tensor(v).numel() * torch.as_tensor(v).element_size()
                             for v in first.values())
        result = _measure(args, trainer, state, source, config, device, warmup)
    finally:
        if stream is not None:
            stream.close()
        if args.work_dir is None:
            shutil.rmtree(work_dir, ignore_errors=True)
    step, compile_s, windows, losses, feeder_stats, device_ms = result
    # The windows are of equal length, so their mean is every window's time
    # over every window's steps.
    sustained = args.feed != "synthetic"
    step_s = statistics.fmean(windows) if sustained else min(windows)
    # What the replays ran, counted where each replay is launched (none on
    # the CPU, where every step runs eagerly).
    graphs = trainer.train_graphs
    replays = graphs.summary()["replays"] if graphs is not None else 0
    peak, peak_source = resolve_peak_flops(args.peak_flops, device,
                                           dtype="int8" if args.quant else "bfloat16")
    smi = card() if device.type == "cuda" else None
    feed = args.feed + (" uint8+device-preprocess" if args.device_preprocess else " bf16")
    feed += "" if config.async_feed else " serial"
    over = "all" if sustained else "best"
    arm = "bf16 with int8 QAT dots" if args.quant else "bf16"
    line = {
        "metric": f"{args.model} train img/s (bs={args.batch_size}, {arm}, {args.backend} "
                  f"attention, {feed} feed, 1 card, {over} of {args.reps}x{args.steps}-step "
                  "windows)",
        # Rounded as finely as step_ms (a microsecond): at 0.1 images/s a
        # slow CPU step (~100 ms) would move value by more than 1e-3 of itself
        # away from batch / step_ms.
        "value": round(args.batch_size / step_s, 3),
        "unit": "img/s",
        "quant": args.quant,
        "feed": args.feed,
        "median_img_per_sec": round(args.batch_size / statistics.median(windows), 3),
        "step_ms": round(step_s * 1e3, 3),
        "window_step_ms": [round(w * 1e3, 3) for w in windows],
        "host_feed_img_per_sec": None if host_rate is None else round(host_rate, 1),
        "device_step_ms": None if device_ms is None else round(device_ms, 3),
        "device_timing_replays": 0 if device_ms is None else DEVICE_TIMING_ITERS + 1,
        "device_idle_share": (None if device_ms is None
                              else round(1.0 - device_ms / (step_s * 1e3), 4)),
        # Four significant figures, not four decimals: a toy step on a
        # loaded CPU against the fake peak is below 5e-5 and would read 0.
        "mfu": float(f"{cost.flops / step_s / peak:.4g}") if peak else None,
        "step_flops": cost.flops,
        "cost_source": cost.source,
        "flops_attribution": {k: round(v, 4) for k, v in cost.attribution.items()},
        "int8_flops_share": (round(int8_flops_share(cost), 4) if args.quant else None),
        "peak_flops": peak,
        "peak_source": peak_source,
        "transfer_bytes_per_batch": transfer_bytes,
        "compile_s": round(compile_s, 3),
        "warmup_steps": warmup,
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
    if args.feed == "pipeline":
        from sav_tpu_torch.data.pipeline import decoder_name

        line["decoder"] = decoder_name()
    if args.feed != "synthetic":
        from sav_tpu_torch.data.native_loader import native_available

        line["native_loader"] = native_available()
    return line


def _measure(args, trainer, state, source, config, device, warmup: int) -> tuple:
    """``(step, compile_s, window step times, window losses, feeder stats,
    device ms per step)``: the captured step (compiled on the first placed
    batch), ``warmup`` warm-up replays, ``reps`` timed windows of ``steps``
    steps, and the device's time for one step on the last placed batch."""
    from sav_tpu_torch.data.feeder import DeviceFeeder

    feeder = (DeviceFeeder(source, trainer.shard_batch, depth=config.feed_depth,
                           name="bench-feeder") if config.async_feed else None)

    def next_placed():
        return next(feeder) if feeder is not None else trainer.shard_batch(next(source))

    try:
        t0 = time.perf_counter()
        placed = next_placed()
        step = trainer.compile_train_step(state, placed)
        compile_s = time.perf_counter() - t0
        for _ in range(warmup):
            state, metrics = step(state, next_placed())
        float(metrics["loss"])  # one device-to-host copy: waits for the step
        windows, losses = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                placed = next_placed()
                state, metrics = step(state, placed)
            losses.append(float(metrics["loss"]))
            windows.append((time.perf_counter() - t0) / args.steps)
    finally:
        feeder_stats = feeder.stats() if feeder is not None else None
        if feeder is not None:
            feeder.close()
    # A fed line's device step on the card (a synthetic feed is the
    # device's own pace already).
    timed = device.type == "cuda" and args.feed != "synthetic"
    device_ms = _device_step_ms(step, state, placed) if timed else None
    return step, compile_s, windows, losses, feeder_stats, device_ms


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
                   help="Timed windows; the best (a fed feed: all) and the median are "
                   "reported.")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--backend", default="auto", choices=["xla", "fused", "pallas", "auto"],
                   help="Attention backend: auto (the port's dispatch rule: the kernels), "
                   "fused, pallas (the flash kernels) or xla (the dense path).")
    p.add_argument("--feed", default="synthetic", choices=["synthetic", "pipeline", "savrec"],
                   help="synthetic: two seeded host batches, placed every step; pipeline: the "
                   "host input pipeline over seeded JPEGs; savrec: a seeded SavRecord file "
                   "through the native loader.")
    p.add_argument("--work-dir",
                   help="Where --feed savrec keeps bench.savrec (written when missing; "
                   "default: a temporary directory, removed at the end).")
    p.add_argument("--device-preprocess", action="store_true",
                   help="Ship post-augment uint8 (half the bf16 bytes); the captured step "
                   f"mixes ({AUGMENT}) and normalises on the card.")
    p.add_argument("--no-async-feed", action="store_true",
                   help="Place each batch on the training thread instead of the feeder's.")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="QAT on the int8 arm (TrainConfig.quant); MFU against the int8 peak")
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
    result = run(args)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
