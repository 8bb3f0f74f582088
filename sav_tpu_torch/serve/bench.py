"""Serving benchmark: open-loop load against one :class:`ServeEngine`.

The port's twin of the single-engine mode of ``tools/serve_bench.py``. It
builds an engine (every bucket captured before admission opens), offers a
synthetic request stream cycling a seeded pool of 16 distinct images, and
prints ONE JSON line: p50/p95/p99 latency, throughput, bucket occupancy,
padding waste, queue depth and deadline overruns (the engine's ledger),
the engine's ``startup_report``, the replays per bucket and the feeder's
counters, what was offered and refused at submit, and the card's name and
power limit as ``nvidia-smi`` gives them (null on the CPU).

Arms:
  --rate 0     flood: every request offered at once (the drain ceiling)
  --rate R     open loop: request i is due at i/R seconds, whether or not
               the server keeps up (so a stall shows in the tail);
               ``schedule_lag_ms`` says how late the generator ran
  --batch-1    ladder [1], the no-batching baseline

``--quant-weights`` serves int8 weights (``ServeConfig.quant_weights``): the
line says ``"quant": "int8"`` (``null`` for the float arm) and carries the
engine's ``startup_report["quant"]``, so an int8 line is never read as a
bf16 one.

Telemetry is on by default, as in the engine: the line carries
``slo_hit_frac`` and ``burn_rate`` (absent when nothing was served) and a
``telemetry`` block (heartbeats, exemplars, the layer's own ``overhead_s``,
``log_dir``). ``--log-dir DIR`` writes the serve run manifest, the
``kind=serve`` heartbeats (``fleet/proc_<i>.jsonl``, every
``--heartbeat-secs``) and the span ring there; ``--no-telemetry`` serves
without it (the overhead A/B arm), and its line has no ``telemetry``
block.

Latency is timed from submit to the future's result. The fleet and chaos
modes of ``tools/serve_bench.py`` wait for ROADMAP queue A5.8.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m sav_tpu_torch.serve.bench --model deit_s_patch16 --max-batch 32 \\
      --requests 2048 --max-queue 4096 --deadline-ms 60000
  python -m sav_tpu_torch.serve.bench --checkpoint runs/ckpt --rate 2000
  python -m sav_tpu_torch.serve.bench --checkpoint runs/ckpt --quant-weights
  python -m sav_tpu_torch.serve.bench --log-dir runs/serve --heartbeat-secs 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sav_tpu_torch.utils.device import card

POOL = 16


def run(args: argparse.Namespace) -> dict:
    """Build the engine ``args`` describe, offer the load, and return the
    result line as a dict."""
    from sav_tpu_torch.serve.batcher import QueueFullError
    from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine

    buckets = [int(b) for b in args.buckets.split(",") if b.strip()] if args.buckets else None
    if args.batch_1:
        buckets = [1]
    config = ServeConfig(
        model_name=args.model,
        num_classes=args.num_classes,
        image_size=args.image_size,
        attention_backend=None if args.backend == "auto" else args.backend,
        model_overrides=json.loads(args.model_overrides) if args.model_overrides else None,
        buckets=buckets,
        max_batch=args.max_batch,
        max_queue=args.max_queue,
        deadline_ms=args.deadline_ms,
        checkpoint_dir=args.checkpoint,
        quant_weights=args.quant_weights,
        log_dir=args.log_dir,
        telemetry=not args.no_telemetry,
        heartbeat_secs=args.heartbeat_secs,
        seed=args.seed,
        device=args.device,
    )
    engine = ServeEngine(config)
    rng = np.random.default_rng(args.seed)
    pool = rng.integers(0, 256, (min(args.requests, POOL), args.image_size, args.image_size, 3),
                        dtype=np.uint8)
    futures, rejected, lag_s = [], 0, 0.0
    with engine:
        t0 = time.monotonic()
        for i in range(args.requests):
            if args.rate > 0:
                due = t0 + i / args.rate
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    lag_s = max(lag_s, -delay)
            try:
                futures.append(engine.submit(pool[i % len(pool)]))
            except QueueFullError:
                rejected += 1
        deadline = time.monotonic() + args.drain_timeout
        for future in futures:
            logits = future.result(timeout=max(deadline - time.monotonic(), 0.1))
            if logits.shape != (args.num_classes,) or not np.isfinite(logits).all():
                raise RuntimeError(f"bad logits: shape {logits.shape}")
    stats = engine.stop()
    summary = stats["ledger"]
    latency = summary.get("latency_ms", {})
    ladder = "bs1" if args.batch_1 else (args.buckets or f"pow2<={args.max_batch}")
    load = f"{args.rate} req/s" if args.rate > 0 else "flood"
    arm = " int8 weights," if args.quant_weights else ""
    out = {
        "metric": (f"{args.model} serve p99 ms ({arm.strip(' ,') + ', ' if arm else ''}"
                   f"buckets {ladder}, {load}, deadline {args.deadline_ms} ms, "
                   f"{args.requests} reqs)"),
        "unit": "ms",
        "quant": "int8" if args.quant_weights else None,
        "outcome": "ok" if not stats["errors"] else "error",
        "platform": "gpu" if engine.device.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(0) if engine.device.type == "cuda" else "cpu",
        "card": card() if engine.device.type == "cuda" else None,
        "p50_latency_ms": latency.get("p50"),
        "p95_latency_ms": latency.get("p95"),
        "p99_latency_ms": latency.get("p99"),
        "serve_throughput": summary["throughput_rps"],
        "padding_waste_frac": summary["padding_waste_frac"],
        "bucket_occupancy": summary["bucket_occupancy"],
        "queue_depth_avg": summary["queue_depth_avg"],
        "queue_depth_max": summary["queue_depth_max"],
        "deadline_overruns": summary["deadline_overruns"],
        "requests": summary["requests"],
        "offered": args.requests,
        "rejected_at_submit": rejected,
        "rate": args.rate,
        "schedule_lag_ms": round(lag_s * 1e3, 3),
        "errors": stats["errors"],
        "summary": summary,
        "startup": engine.startup_report,
        "replays": stats["replays"],
        "feeder": stats["feeder"],
    }
    slo = stats.get("slo") or {}
    if isinstance(slo.get("hit_frac"), (int, float)):
        out["slo_hit_frac"] = slo["hit_frac"]
        out["burn_rate"] = slo.get("burn_rate")
    telemetry = stats.get("telemetry")
    if telemetry is not None:
        out["telemetry"] = {
            "heartbeats": int(telemetry.get("heartbeats", 0)),
            "exemplars": int(telemetry.get("exemplars", 0)),
            "overhead_s": telemetry.get("overhead_s"),
            "log_dir": args.log_dir,
        }
    if engine.manifest is not None:
        engine.manifest.note("metric", out["metric"])
        engine.manifest.note("platform", out["platform"])
        out["manifest"] = engine.manifest.path
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="deit_s_patch16")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "fused", "pallas"],
                   help="attention backend (auto = the port's dispatch rule)")
    p.add_argument("--model-overrides", default=None, metavar="JSON")
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch-size ladder (default: powers of two up to "
                        "--max-batch); one captured program per rung")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-1", action="store_true", help="ladder [1]: the no-batching baseline")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--deadline-ms", type=float, default=100.0)
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint directory to serve (params-only restore)")
    p.add_argument("--quant-weights", action="store_true",
                   help="serve int8 weights (the float parameters quantized per channel)")
    p.add_argument("--requests", type=int, default=512, help="requests to offer")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop offered load in req/s (0 = flood everything at once)")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="seconds to wait for the last future")
    p.add_argument("--log-dir", default=None,
                   help="serve run manifest and telemetry sink (heartbeats, slow-request "
                        "exemplars, the span ring); default: no files")
    p.add_argument("--no-telemetry", action="store_true",
                   help="serve without telemetry (spans, windows, heartbeats, SLO): the "
                        "overhead A/B arm")
    p.add_argument("--heartbeat-secs", type=float, default=5.0,
                   help="serve heartbeat cadence (kind=serve lines in fleet/proc_<i>.jsonl; "
                        "0 disables)")
    p.add_argument("--seed", type=int, default=0, help="weights (fresh init) and request pool")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    out = run(parser().parse_args(argv))
    print(json.dumps(out))
    return 0 if out["outcome"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
