"""Training for the PyTorch port (mirrors ``sav_tpu/train``).

``python -m sav_tpu_torch.train`` is the command-line twin of ``train.py``
for what the port carries (:func:`main`), ``--supervise`` included. The
names below load on first use, so that the supervising process imports
neither torch nor numpy.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Optional

_EXPORTS = {
    "Checkpointer": "sav_tpu_torch.train.checkpoint",
    "TrainConfig": "sav_tpu_torch.train.config",
    "TrainState": "sav_tpu_torch.train.state",
    "Trainer": "sav_tpu_torch.train.trainer",
    "get_preset": "sav_tpu_torch.train.presets",
    "preset_names": "sav_tpu_torch.train.presets",
}

__all__ = sorted([*_EXPORTS, "main"])


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'sav_tpu_torch.train' has no attribute {name!r}")


# Exit codes, as train.py's: 0 done, 1 failed, 2 usage error, 3 the card
# unreachable at the start (backend probe), 4 hung (watchdog).
EXIT_BACKEND = 3

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
    "log_dir": "log_dir", "trace_spans": "trace_spans", "watchdog_secs": "watchdog_secs",
    "watchdog_soft_secs": "watchdog_soft_secs", "fleet": "fleet", "debug_nans": "debug_nans",
    "record": "record", "record_depth": "record_depth", "record_batches": "record_batches",
    "record_snapshot_every": "record_snapshot_every", "spike_sigma": "spike_sigma",
    "augmentation": "augment", "num_train_images": "num_train_images", "quant": "quant",
}


def _crop_area(text: str) -> float:
    value = float(text)
    if not 0.0 < value <= 1.0:
        raise argparse.ArgumentTypeError(f"{value} is not in (0, 1]")
    return value


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sav_tpu_torch.train",
        description="Train a sav_tpu_torch model from TFRecord shards, synthetic or fake "
        "data (the flags of train.py that the port carries). Flags given override "
        "the preset; the others keep its values (or TrainConfig's defaults). "
        "Exit codes: 0 done, 1 failed, 2 usage error, 3 the card unreachable "
        "at the start, 4 hung (watchdog).",
    )
    data = p.add_mutually_exclusive_group(required=True)
    data.add_argument("--data-dir",
                      help="TFRecord root: train-* and validation-* shards of tf.train.Example "
                      "images (image/encoded, image/class/label).")
    data.add_argument("--fake-data", action="store_true", help="Zero batches, no real data.")
    data.add_argument(
        "--synth-data", action="store_true",
        help="Deterministic learnable synthetic batches (class id as a brightness offset), "
        "a pure function of the step: a resumed run reads the batches an "
        "uninterrupted run would.",
    )
    p.add_argument("--preset", default=None,
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
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="QAT on the int8 arm: every projection, FF and head dot int8 x int8 "
                   "-> int32 with per-channel scales, the gradient dots int8 with the "
                   "cotangent rounded stochastically; the attention core stays in the "
                   "compute dtype. The checkpoint is the float tree (serve it with "
                   "--quant-weights).")
    p.add_argument("-a", "--augmentation",
                   help="Augment-string DSL (default cutmix_mixup_randaugment_405).")
    p.add_argument("--num-train-images", type=int,
                   help="Train-split size for a non-ImageNet TFRecord dataset (turns off the "
                   "10k VALID carve-out and the 1-indexed label shift).")
    p.add_argument("--num-eval-images", type=int,
                   help="Eval-split size for a non-ImageNet TFRecord dataset.")
    p.add_argument("--crop-min-area", type=_crop_area, default=0.08,
                   help="Lower bound of the Inception crop's area range, in (0, 1].")
    p.add_argument("--train-flip", action=argparse.BooleanOptionalAction, default=True,
                   help="Random horizontal flip in train preprocessing.")
    p.add_argument("--eval-only", action="store_true",
                   help="Restore from -c (or --init-from) and run one evaluation pass; no "
                   "training.")
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
    p.add_argument("--backend-wait", type=float, default=600.0,
                   help="Seconds to probe the card (from a subprocess: is_available, one "
                   "launch, a synchronize) before aborting with exit 3. Ignored with "
                   "--device cpu.")
    obs = p.add_argument_group("telemetry (written under --log-dir, else -c)")
    obs.add_argument("--log-dir",
                     help="Telemetry sink: manifest.json, metrics.jsonl, goodput.json, fleet/, "
                     "incidents/ and (with --trace-spans) spans.trace.json. Default: the "
                     "checkpoint directory; with neither, no telemetry file is written.")
    obs.add_argument("--trace-spans", action=argparse.BooleanOptionalAction, default=None,
                     help="Host spans around fit's phases into spans.trace.json (Perfetto).")
    obs.add_argument("--watchdog-secs", type=float,
                     help="Exit 4 (after dumping stacks, an incident and the manifest) when no "
                     "step completes within this many seconds; armed after the first step.")
    obs.add_argument("--watchdog-soft-secs", type=float,
                     help="The watchdog's warning stage (< --watchdog-secs): stacks and a fleet "
                     "event, the run goes on.")
    obs.add_argument("--fleet", action=argparse.BooleanOptionalAction, default=None,
                     help="Heartbeats into fleet/proc_<i>.jsonl at each log boundary, "
                     "fleet/fleet.json at the end (default on).")
    obs.add_argument("--debug-nans", action=argparse.BooleanOptionalAction, default=None,
                     help="Check every step's metrics on the host (one small copy a step): the "
                     "run dies 'nonfinite' at the bad step, before any later save.")
    obs.add_argument("--record", action=argparse.BooleanOptionalAction, default=None,
                     help="Flight recorder: incident bundles under incidents/step_<N>/ on "
                     "nonfinite metrics, a loss spike, a hang or a crash.")
    obs.add_argument("--record-depth", type=int, help="Steps of context the recorder keeps.")
    obs.add_argument("--record-batches", type=int, help="Raw host batches the recorder keeps.")
    obs.add_argument("--record-snapshot-every", type=int,
                     help="Steps between the recorder's state snapshots (<= --record-batches).")
    obs.add_argument("--spike-sigma", type=float,
                     help="Loss-spike gate in scaled MADs above the rolling median (0: off).")
    sup = p.add_argument_group("supervision")
    sup.add_argument("--supervise", action="store_true",
                     help="Run this command as a child under bounded-restart supervision: "
                     "exits 3 and 4, crashes and signals restart with backoff, resuming from "
                     "-c (required); supervisor.json and attempts/ in the sink. The "
                     "supervising process imports no torch.")
    sup.add_argument("--max-restarts", type=int, default=16,
                     help="Supervisor restart budget (attempts = restarts + 1).")
    sup.add_argument("--restart-backoff", type=float, default=5.0,
                     help="Backoff base in seconds (doubles each restart, capped at 300).")
    sup.add_argument("--skip-steps",
                     help="Comma-separated 1-indexed schedule steps whose batches are dropped "
                     "once (rewind-and-skip; the supervisor passes them after a nonfinite "
                     "incident).")
    return p


def main(argv: Optional[list] = None) -> dict:
    """Parse ``argv``, train, print one JSON line of the final metrics and
    return it; with ``--supervise``, run the same command as a supervised
    child and exit with the chain's code.

    A run with a telemetry sink writes ``manifest.json`` there and
    finalizes it on every way out: ``ok``; an exception classified
    (``nonfinite``, ``oom``, ``error``; exit 1); a usage error (exit 2);
    the probe's ``backend_unreachable`` (exit 3); the watchdog's ``hang``
    (exit 4)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = _parser()
    args = parser.parse_args(argv)
    if args.supervise:
        raise SystemExit(_supervise(parser, args, argv))
    from sav_tpu_torch.obs.fleet import resolve_identity
    from sav_tpu_torch.obs.manifest import RunManifest, classify_exception

    sink = args.log_dir or args.checkpoint_dir
    manifest = None
    if sink is not None:
        manifest = RunManifest(os.path.join(sink, "manifest.json"), kind="train", argv=argv)
        if resolve_identity(0, 1)[0] != 0:
            manifest.disable()  # one manifest writer per sink: process 0
        manifest.begin()
    try:
        final = _run(parser, args, manifest)
    except SystemExit as e:
        # The probe finalized 'backend_unreachable' first (finalize is
        # first-wins); a usage error (exit 2) or any other exit lands here.
        if manifest is not None and not manifest.finalized:
            ok = e.code is None or e.code == 0
            code = e.code if isinstance(e.code, int) else (0 if ok else 1)
            manifest.finalize("ok" if ok else "error",
                              error=None if ok else f"SystemExit({e.code!r})", exit_code=code)
        raise
    except BaseException as e:
        if manifest is not None:
            manifest.finalize(classify_exception(e), error=repr(e), exit_code=1)
        raise
    if manifest is not None:
        manifest.finalize("ok", exit_code=0)
    return final


def _supervise(parser: argparse.ArgumentParser, args, argv: list) -> int:
    """``--supervise``: this command, less the supervisor's flags, as the
    child of a :class:`~sav_tpu_torch.train.supervisor.Supervisor`. Stdlib
    only: the supervising process never starts CUDA."""
    from sav_tpu_torch.train.supervisor import (
        Supervisor,
        parse_skip_steps,
        strip_supervisor_flags,
    )

    if not args.checkpoint_dir:
        parser.error("--supervise needs -c/--checkpoint-dir: restarts resume from its "
                     "checkpoints")
    try:
        # The user's skips seed the supervisor's cumulative set, which it
        # passes to every attempt; the child never sees two --skip-steps.
        user_skips = parse_skip_steps(args.skip_steps)
    except ValueError as e:
        parser.error(str(e))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    child_argv = [sys.executable, "-m", "sav_tpu_torch.train",
                  *strip_supervisor_flags(argv, extra_value_flags=("--skip-steps",))]
    supervisor = Supervisor(
        child_argv,
        log_dir=args.log_dir or args.checkpoint_dir,
        checkpoint_dir=args.checkpoint_dir,
        max_restarts=args.max_restarts,
        backoff_base_s=args.restart_backoff,
        skip_steps=user_skips,
        env={"PYTHONPATH": root + (os.pathsep + path if path else "")},
    )
    return supervisor.run()


def _run(parser: argparse.ArgumentParser, args, manifest) -> dict:
    """The run under :func:`main`'s manifest."""
    from sav_tpu_torch.train.supervisor import (
        chaos_wrap,
        parse_skip_steps,
        resume_schedule_position,
        skip_step_batches,
    )

    if args.watchdog_soft_secs is not None and (
            args.watchdog_secs is None or args.watchdog_soft_secs >= args.watchdog_secs):
        parser.error("--watchdog-soft-secs needs --watchdog-secs and must be smaller than it "
                     "(soft warns, hard aborts)")
    try:
        skip = parse_skip_steps(args.skip_steps)
    except ValueError as e:
        parser.error(str(e))
    if args.synth_data and args.eval_only:
        parser.error("--eval-only has no synthetic eval split; use --fake-data or a real "
                     "--data-dir")
    if (args.num_train_images is None) != (args.num_eval_images is None):
        # Both flip the TFRecord reader into custom-dataset mode (0-indexed
        # labels, no VALID carve-out); mixing modes would corrupt eval labels.
        parser.error("--num-train-images and --num-eval-images must be passed together")
    probe = None
    if args.device != "cpu":
        from sav_tpu_torch.utils.backend_probe import require_backend_or_exit, start_probe

        probe = start_probe()  # it runs while torch imports, which starts no CUDA
    try:
        from sav_tpu_torch.data.synthetic import fake_data_iterator, synth_resumable_iterator
        from sav_tpu_torch.obs.fleet import resolve_identity
        from sav_tpu_torch.obs.recorder import batch_fingerprint
        from sav_tpu_torch.train.config import TrainConfig
        from sav_tpu_torch.train.presets import get_preset, preset_names
        from sav_tpu_torch.train.trainer import Trainer
        from sav_tpu_torch.utils.writers import JsonlWriter

        if args.preset is not None and args.preset not in preset_names():
            parser.error(f"--preset {args.preset!r} is not one of {preset_names()}")
        if probe is not None:
            # Before this process starts CUDA; exit 3 with the manifest
            # finalized 'backend_unreachable', never a run on the CPU.
            require_backend_or_exit(args.backend_wait, tag="train", manifest=manifest,
                                    exit_code=EXIT_BACKEND, started=probe)
    finally:
        if probe is not None and probe.poll() is None:  # a usage error came first
            probe.kill()
            probe.communicate()
    fields = {field: getattr(args, flag) for flag, field in _FLAG_TO_FIELD.items()
              if getattr(args, flag) is not None}
    # Synthetic batches come NHWC; the fake pipeline ships HWCN.
    fields["transpose_images"] = not args.synth_data
    config = get_preset(args.preset, **fields) if args.preset else TrainConfig(**fields)
    if manifest is not None:
        import dataclasses

        manifest.set_config(dataclasses.asdict(config))
    trainer = Trainer(config, device=args.device)
    # Restore before the data stream is built, so that it starts at the
    # restored step; a resumable checkpoint wins over --init-from.
    state = trainer.restore_or_init()
    if args.init_from and state.step == 0:
        state = trainer.warm_start_from(args.init_from)
    start_step = state.step
    # Rewind-and-skip shifts the schedule: after position p was dropped,
    # step s >= p consumed a later batch, so a restart past a skip starts
    # its position-keyed stream at the shifted position, with only the
    # skips not reached yet armed.
    start_pos = resume_schedule_position(start_step, skip)
    skip = {p for p in skip if p > start_pos}
    eval_iter_fn = None if args.synth_data else _eval_iter_fn(args, config)
    if args.eval_only:
        return _eval_only(parser, args, trainer, state, eval_iter_fn, manifest)
    if args.data_dir is not None:
        from sav_tpu_torch.data.pipeline import Split, resumable_train_iterator

        batches = resumable_train_iterator(
            Split.TRAIN, start_step=start_pos, seed=config.seed, data_dir=args.data_dir,
            batch_dims=[config.global_batch_size], image_size=config.image_size,
            augment_name=config.augment, transpose=config.transpose_images,
            bfloat16=config.compute_dtype == "bfloat16",
            device_preprocess=config.device_preprocess, split_examples=args.num_train_images,
            crop_area_range=(args.crop_min_area, 1.0), random_flip=args.train_flip,
        )
    elif args.synth_data:
        batches = synth_resumable_iterator(
            seed=config.seed, start_step=start_pos, batch_size=config.global_batch_size,
            image_size=config.image_size, num_classes=config.num_classes,
        )
    else:
        batches = fake_data_iterator(
            batch_size=config.global_batch_size, image_size=config.image_size,
            num_classes=config.num_classes, transpose=config.transpose_images,
        )
    # The elasticity wrappers in train.py's order: fault injection nearest
    # the source (so a skip drops a poisoned batch), the skip, then the
    # resume probe, which fingerprints the batch actually trained next.
    batches = chaos_wrap(batches, start_step=start_pos)
    if skip:
        skipped: dict = {}

        def on_skip(pos, batch):
            skipped[str(pos)] = batch_fingerprint(batch)["hash"]
            if manifest is not None:
                manifest.note("rewind_skip", {"steps": sorted(int(k) for k in skipped),
                                              "hashes": dict(skipped)})
            print(f"rewind-and-skip: dropped the batch at schedule step {pos} "
                  f"({skipped[str(pos)][:12]}…)", file=sys.stderr)

        batches = skip_step_batches(batches, skip, start_step=start_pos, on_skip=on_skip)
    attempt = os.environ.get("SAV_SUPERVISED_ATTEMPT")
    if attempt and manifest is not None:
        manifest.note("supervisor", {"attempt": int(attempt)})

    def resume_probe(it):
        first = True
        for batch in it:
            if first and manifest is not None:
                manifest.note("resume", {
                    "from_step": start_step,
                    "schedule_position": start_pos,
                    "skip_steps": sorted(skip),
                    "next_batch_hash": batch_fingerprint(batch)["hash"],
                    "rng": "the trainer's generators resume from the checkpoint's states",
                })
            first = False
            yield batch

    writer = None
    if (config.log_dir or config.checkpoint_dir) and resolve_identity(0, 1)[0] == 0:
        writer = JsonlWriter(config.log_dir or config.checkpoint_dir)

    def log_fn(record: dict) -> None:
        if writer is not None:
            writer.write(int(record.get("step", 0)), record)

    try:
        state, history = trainer.fit(resume_probe(batches), num_steps=args.steps, state=state,
                                     eval_iter_fn=eval_iter_fn if args.data_dir else None,
                                     log_fn=log_fn, manifest=manifest)
    finally:
        if writer is not None:
            writer.close()
    if trainer.checkpointer is not None:
        trainer.checkpointer.close()
    final = {"step": state.step, "start_step": start_step, "device": str(trainer.device)}
    train_records = [r for r in history if "loss" in r]
    if train_records:
        final.update(train_records[-1])
    eval_records = [r for r in history if "eval_count" in r]
    if eval_records:
        final.update(eval_records[-1])
    print(json.dumps(final), flush=True)
    return final


def _eval_iter_fn(args, config):
    """A fresh pass over the eval split (``Split.TEST``) per call: the
    TFRecord pipeline under ``--data-dir``, zero batches under
    ``--fake-data``."""
    from sav_tpu_torch.data.pipeline import Split, load

    def eval_iter():
        return load(Split.TEST, data_dir=args.data_dir, is_training=False,
                    batch_dims=[config.global_batch_size], image_size=config.image_size,
                    transpose=config.transpose_images,
                    bfloat16=config.compute_dtype == "bfloat16",
                    device_preprocess=config.device_preprocess, fake_data=args.fake_data,
                    split_examples=args.num_eval_images)

    return eval_iter


def _eval_only(parser, args, trainer, state, eval_iter_fn, manifest) -> dict:
    """``--eval-only``: one evaluation pass of the restored state, printed
    as one JSON line with its step."""
    import itertools

    from sav_tpu_torch.ops import launch_counts

    if state.step == 0 and not args.init_from:
        # Fresh weights would give plausible-looking chance-level metrics.
        parser.error("--eval-only found no checkpoint to evaluate: -c holds none and "
                     "--init-from was not given")
    eval_iter = eval_iter_fn()
    if args.fake_data:
        eval_iter = itertools.islice(eval_iter, 4)  # the fake stream never ends
    metrics = trainer.evaluate(state, eval_iter)
    final = {"step": state.step, **metrics, "device": str(trainer.device)}
    if manifest is not None:
        note = {"launches": launch_counts()}
        if trainer.eval_graphs is not None:
            note.update(trainer.eval_graphs.summary())
        manifest.note("kernels", note)
        manifest.finalize("ok", exit_code=0, metrics={k: float(v) for k, v in metrics.items()})
    print(json.dumps(final), flush=True)
    return final
