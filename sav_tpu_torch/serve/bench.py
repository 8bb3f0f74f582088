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

Latency is timed from submit to the future's result.

Fleet mode (``--replicas N``): N supervised engine replicas
(:mod:`sav_tpu_torch.serve.serve_fleet` in replica mode, one shared log
dir) behind the wait-aware :class:`~sav_tpu_torch.serve.router.Router`;
the same open-loop or flood load goes through ``Router.admit``, and ONE
fleet JSON line comes out: ``fleet_p50/p95/p99_latency_ms`` and
``fleet_throughput`` (router-observed, admit to reply), the client-side
``accounting`` (offered = completed + shed + closed + errors, ``lost``
must be 0), ``rerouted`` and ``transport_failures``, the pool's restarts,
each replica's startup, platform and served batches, the router summary,
and — skipped rather than zero-filled — ``quality_agreement`` (the shadow's)
and ``probe_ok_frac`` (the replicas' probes, folded from their beats).
``--shadow-rank R`` mirrors a ``--shadow-frac`` sample of completed
requests to replica R (which serves no routed traffic) and scores
agreement; ``--probe-every S`` runs the golden probe on every replica;
``--chaos-kill-rank R`` SIGKILLs replica R after ``--chaos-kill-at-frac``
of the requests were offered, waits for its supervisor to restart it and
floods a ``--probe-requests`` burst to show the router routes to it again
(``probe_routed``); ``--inject-delay RANK:SECONDS`` slows one replica per
batch; ``--noise-weights RANK:SCALE`` perturbs one replica's weights. The
parent imports no torch in fleet mode: the replicas own the card, and the
card's name and power limit come from ``nvidia-smi``.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m sav_tpu_torch.serve.bench --model deit_s_patch16 --max-batch 32 \\
      --requests 2048 --max-queue 4096 --deadline-ms 60000
  python -m sav_tpu_torch.serve.bench --checkpoint runs/ckpt --rate 2000
  python -m sav_tpu_torch.serve.bench --checkpoint runs/ckpt --quant-weights
  python -m sav_tpu_torch.serve.bench --log-dir runs/serve --heartbeat-secs 1
  python -m sav_tpu_torch.serve.bench --replicas 3 --shadow-rank 2 --max-batch 32 \
      --requests 1024 --max-queue 2048 --deadline-ms 60000 --log-dir runs/fleet \
      --probe-every 2 --chaos-kill-rank 1
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from sav_tpu_torch.serve.serve_fleet import NOT_CARRIED, not_carried

POOL = 16


def run(args: argparse.Namespace) -> dict:
    """Build the engine ``args`` describe, offer the load, and return the
    result line as a dict."""
    import torch

    from sav_tpu_torch.serve.batcher import QueueFullError
    from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
    from sav_tpu_torch.utils.device import card

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
        slo_target=args.slo_target,
        probe_every_s=args.probe_every,
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
    quality = stats.get("quality") or {}
    if isinstance(quality.get("probe_ok_frac"), (int, float)):
        # Only when probes ran: skipped, never zero-filled.
        out["probe_ok_frac"] = quality["probe_ok_frac"]
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


def _smi() -> "str | None":
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    without importing torch (fleet mode's parent); None without nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _parse_rank_value(spec, flag: str, what: str) -> tuple:
    """``"1:0.4"`` -> (rank 1, 0.4); ``(None, 0.0)`` when unset."""
    if not spec:
        return None, 0.0
    rank, _, value = str(spec).partition(":")
    try:
        return int(rank), float(value)
    except ValueError:
        raise ValueError(f"{flag} wants RANK:{what}, got {spec!r}") from None


def _replica_manifest(log_dir: str, rank: int) -> dict:
    """What rank ``rank``'s last attempt served, from its manifest: outcome,
    platform, requests, batches, replays per bucket and the captured
    launches of each bucket (launches = replays x captured)."""
    try:
        with open(os.path.join(log_dir, f"manifest-serve-r{rank}.json")) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    notes = doc.get("notes") or {}
    startup = notes.get("serve_startup") or {}
    summary = notes.get("serve_summary") or {}
    return {"outcome": doc.get("outcome"), "device": startup.get("device"),
            "requests": summary.get("requests"), "batches": summary.get("batches"),
            "replays": notes.get("replays"),
            "captured_launches": startup.get("captured_launches"),
            "captured_variants": startup.get("captured_variants"),
            "quality": notes.get("quality")}


def run_fleet(args) -> dict:
    """Fleet mode: pool, router, open-loop or flood load through
    ``Router.admit``, the optional chaos arms; returns the fleet line. The
    parent stays torch-free: every number here is host wall-clock
    accounting at the router."""
    from sav_tpu_torch.obs.alerts import episodes as alert_episodes
    from sav_tpu_torch.obs.alerts import read_alerts
    from sav_tpu_torch.obs.manifest import RunManifest, classify_exception
    from sav_tpu_torch.obs.rollup import Roller
    from sav_tpu_torch.serve import serve_fleet as fleet_cli
    from sav_tpu_torch.serve.batcher import QueueFullError, ServeClosedError
    from sav_tpu_torch.serve.fleet import TcpTransport, read_endpoints
    from sav_tpu_torch.serve.router import Router
    from sav_tpu_torch.serve.telemetry import aggregate_serve, router_views

    log_dir = args.log_dir
    os.makedirs(log_dir, exist_ok=True)
    manifest = RunManifest(
        os.path.join(log_dir, f"manifest-fleet-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"),
        kind="serve_fleet", argv=sys.argv[1:])
    manifest.begin()
    delay_rank, delay_s = _parse_rank_value(args.inject_delay, "--inject-delay", "SECONDS")
    noise_rank, noise_scale = _parse_rank_value(args.noise_weights, "--noise-weights", "SCALE")

    def env_fn(rank):
        env = {}
        if rank == delay_rank and delay_s > 0:
            env["SAV_CHAOS_SERVE_DELAY_S"] = str(delay_s)
        # The planted-corruption arm: this replica perturbs its float
        # weights at load, before any quantization.
        if rank == noise_rank and noise_scale > 0:
            env["SAV_CHAOS_NOISE_WEIGHTS"] = str(noise_scale)
        return env

    pool = fleet_cli.build_pool(args, log_dir, env_fn=env_fn)
    pool.start()
    transport = TcpTransport(log_dir)
    router = None
    try:
        ready = pool.wait_ready(args.replica_startup_timeout, transport=transport)
        platform = next((d.get("platform") for d in ready.values() if d.get("platform")), None)
        # Seed the router's step estimate from the replicas' timed warm-ups
        # (the batcher's own seed, read over the wire).
        step_seed = 0.05
        for doc in ready.values():
            warm = ((doc.get("startup") or {}).get("warmup_step_s")) or {}
            steps = [v for v in warm.values() if isinstance(v, (int, float))]
            if steps:
                step_seed = max(steps)
                break
        deadline_s = args.deadline_ms / 1e3
        router = Router(
            transport,
            views_fn=lambda: router_views(log_dir),
            max_batch=args.max_batch,
            default_step_s=step_seed,
            default_deadline_s=deadline_s,
            max_inflight=args.max_queue,
            refresh_secs=args.router_refresh_secs,
            ranks=range(args.replicas),
            workers=args.fleet_workers,
            log_dir=log_dir,
            heartbeat_secs=args.heartbeat_secs,
            shadow_rank=args.shadow_rank,
            shadow_frac=args.shadow_frac,
        )
        rng = np.random.default_rng(args.seed)
        payloads = [rng.integers(0, 256, (args.image_size, args.image_size, 3),
                                 dtype=np.uint8).tobytes()
                    for _ in range(min(args.requests, POOL) or 1)]
        chaos = None
        if args.chaos_kill_rank is not None:
            chaos = {"rank": args.chaos_kill_rank,
                     "kill_at_request": max(int(args.requests * args.chaos_kill_at_frac), 1)}
        futures = []
        admit_rejects = 0
        t0 = time.monotonic()
        for i in range(args.requests):
            if args.rate > 0:
                delay = t0 + i / args.rate - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            if chaos and i == chaos["kill_at_request"]:
                chaos["killed_pid"] = pool.kill(chaos["rank"])
                chaos["kill_unix"] = round(time.time(), 3)
            try:
                futures.append(router.admit(payloads[i % len(payloads)], deadline_s=deadline_s))
            except QueueFullError:
                admit_rejects += 1  # the router books it as rejected or shed_admit
        drain_deadline = time.monotonic() + args.drain_timeout
        counts = {"completed": 0, "shed": 0, "closed": 0, "errors": 0}
        for future in futures:
            try:
                future.result(timeout=max(drain_deadline - time.monotonic(), 0.1))
                counts["completed"] += 1
            except ServeClosedError:
                counts["closed"] += 1
            except QueueFullError:  # RouterShedError subclasses it
                counts["shed"] += 1
            except Exception:  # noqa: BLE001 — an app error or a stuck future
                counts["errors"] += 1
        # The fleet's headline BEFORE any probe traffic: the burst below
        # shows the victim folded back in; it is not a measurement.
        summary = router.summary()
        probe_routed = None
        if chaos and chaos.get("killed_pid"):
            victim = chaos["rank"]
            rec_deadline = time.monotonic() + args.chaos_recovery_timeout
            while time.monotonic() < rec_deadline:
                doc = read_endpoints(log_dir).get(victim)
                if doc is not None and doc.get("pid") != chaos["killed_pid"]:
                    try:
                        transport.invalidate(victim)
                        ping = transport.ping(victim)
                        chaos["restored_unix"] = round(time.time(), 3)
                        chaos["outage_s"] = round(chaos["restored_unix"] - chaos["kill_unix"], 3)
                        chaos["restart_startup"] = ping.get("startup")
                        break
                    except Exception:  # noqa: BLE001 — still starting
                        pass
                time.sleep(0.25)
            if chaos.get("restored_unix") and args.probe_requests > 0:
                active_deadline = time.monotonic() + max(args.heartbeat_secs * 20, 10.0)
                while time.monotonic() < active_deadline:
                    router.refresh()
                    if router.stats()["replicas"].get(str(victim), {}).get("state") == "active":
                        break
                    time.sleep(0.2)
                base = {rank: v["routed"] for rank, v in router.stats()["replicas"].items()}
                probe_futs = []
                # Long enough to absorb a cold replica, short enough that a
                # lone request's wait for its bucket to fill cannot stall
                # the bench for the whole serving deadline.
                probe_deadline_s = max(min(deadline_s, 2.0), 1.0)
                for i in range(args.probe_requests):
                    try:
                        probe_futs.append(router.admit(payloads[i % len(payloads)],
                                                       deadline_s=probe_deadline_s))
                    except QueueFullError:
                        pass
                for future in probe_futs:
                    try:
                        future.result(timeout=30.0)
                    except Exception:  # noqa: BLE001 — the burst only counts routes
                        pass
                probe_routed = {rank: v["routed"] - base.get(rank, 0)
                                for rank, v in router.stats()["replicas"].items()}
            if chaos.get("restored_unix") and args.probe_every > 0:
                # The restarted process must run the probe on its own bits:
                # wait (bounded) until its beats show a probe.
                probe_deadline = time.monotonic() + args.chaos_recovery_timeout
                while time.monotonic() < probe_deadline:
                    view = aggregate_serve(log_dir, now=time.time()).get(
                        "replicas", {}).get(str(victim)) or {}
                    if (view.get("pid") != chaos["killed_pid"]
                            and ((view.get("quality") or {}).get("probe_runs") or 0) > 0):
                        chaos["probe_after_restart"] = view["quality"]
                        break
                    time.sleep(0.25)
    except BaseException as e:
        # A fleet that never came up (or a caller unwinding) must not leave
        # its manifest "running".
        manifest.finalize(classify_exception(e), error=repr(e), exit_code=1)
        raise
    finally:
        if router is not None:
            router.close()
        status = pool.stop()
    # The router's heartbeat thread rolled the streams in-run; one final
    # roll and flush folds the tail beats (the router is stopped, so the
    # single-writer cursor is free).
    roller = Roller(log_dir)
    roller.roll_once()
    roller.flush()
    fleet_fold = (aggregate_serve(log_dir) or {}).get("fleet") or {}
    alert_eps = alert_episodes(read_alerts(log_dir))
    latency = summary.get("latency_ms") or {}
    # Client-side ledger: every offered request resolved as exactly one of
    # completed / shed (an admission reject or a deadline shed on the
    # future) / closed / errors. A silently lost request would surface as a
    # stuck future, so lost == 0 and errors == 0 together are the proof.
    shed_total = counts["shed"] + admit_rejects
    accounting = {
        "offered": args.requests,
        "completed": counts["completed"],
        "shed": shed_total,
        "shed_at_admit": admit_rejects,
        "closed": counts["closed"],
        "errors": counts["errors"],
        "lost": (args.requests - counts["completed"] - shed_total - counts["closed"]
                 - counts["errors"]),
    }
    load_desc = f"{args.rate} req/s" if args.rate > 0 else "flood"
    outcome = "ok" if counts["errors"] == 0 and accounting["lost"] == 0 else "error"
    endpoints = read_endpoints(log_dir)
    traces_dir = os.path.join(log_dir, "serve_traces")
    router_export = os.path.join(traces_dir, "requests_router.trace.json.gz")
    out = {
        "metric": (f"{args.model} fleet p99 ms ({args.replicas} replicas, {load_desc}, "
                   f"deadline {args.deadline_ms} ms, {args.requests} reqs)"),
        "unit": "ms",
        "outcome": outcome,
        "platform": platform,
        "card": _smi() if platform == "gpu" else None,
        "replicas": args.replicas,
        "fleet_p50_latency_ms": latency.get("p50"),
        "fleet_p95_latency_ms": latency.get("p95"),
        "fleet_p99_latency_ms": latency.get("p99"),
        "fleet_throughput": summary.get("throughput_rps"),
        "fleet_capacity_rps": fleet_fold.get("capacity_rps"),
        "fleet_headroom_frac": fleet_fold.get("headroom_frac"),
        "fleet_shed": shed_total,
        "accounting": accounting,
        "rerouted": summary["rerouted"],
        "transport_failures": summary["transport_failures"],
        "router_overhead_ms": summary.get("router_overhead_ms"),
        "restarts": status["restarts"],
        "pool": status,
        "startup_warm": {str(rank): (doc.get("startup") or {}).get("compiled_from_scratch")
                         for rank, doc in sorted(endpoints.items())},
        "replica_platforms": {str(rank): doc.get("platform")
                              for rank, doc in sorted(endpoints.items())},
        "replica_runs": {str(rank): _replica_manifest(log_dir, rank)
                         for rank in range(args.replicas)},
        "router": summary,
        "serve_traces": {
            "router": router_export if os.path.isfile(router_export) else None,
            "replicas": sorted(glob.glob(os.path.join(traces_dir, "requests_proc*.trace.json.gz"))),
        },
        "manifest": manifest.path,
        "log_dir": log_dir,
        # The replicas own the card: this process never loaded torch.
        "parent_imported_torch": "torch" in sys.modules,
    }
    if chaos:
        out["chaos"] = chaos
    if probe_routed is not None:
        out["probe_routed"] = probe_routed
    # The shadow block is read again after close: the shadow worker drains
    # its mirror queue inside close(), so the block snapshotted before it
    # would undercount. Both quality figures skip rather than zero-fill.
    shadow = (router.summary().get("shadow") if router is not None else None) \
        or summary.get("shadow") or {}
    if shadow:
        summary["shadow"] = shadow
    if isinstance(shadow.get("agreement"), (int, float)):
        out["quality_agreement"] = shadow["agreement"]
    if isinstance(fleet_fold.get("probe_ok_frac"), (int, float)):
        out["probe_ok_frac"] = fleet_fold["probe_ok_frac"]
    if alert_eps:
        out["alerts"] = alert_eps
        manifest.note("alerts", alert_eps)
    metrics = {"fleet/replicas": float(args.replicas), "fleet/restarts": float(status["restarts"]),
               "fleet/shed": float(shed_total), "fleet/rerouted": float(summary["rerouted"])}
    for key, value in (("fleet/p99_latency_ms", latency.get("p99")),
                       ("fleet/throughput_rps", summary.get("throughput_rps")),
                       ("fleet/router_overhead_ms", summary.get("router_overhead_ms")),
                       ("fleet/headroom_frac", fleet_fold.get("headroom_frac")),
                       ("fleet/quality_agreement", shadow.get("agreement")),
                       ("fleet/probe_ok_frac", fleet_fold.get("probe_ok_frac"))):
        if isinstance(value, (int, float)):
            metrics[key] = float(value)
    manifest.note("metric", out["metric"])
    manifest.note("fleet", {"pool": status, "accounting": accounting, "chaos": chaos,
                            "probe_routed": probe_routed,
                            "capacity_rps": fleet_fold.get("capacity_rps"),
                            "headroom_frac": fleet_fold.get("headroom_frac")})
    if shadow or isinstance(fleet_fold.get("probe_ok_frac"), (int, float)):
        manifest.note("quality", {"shadow": shadow or None,
                                  "probe_ok_frac": fleet_fold.get("probe_ok_frac")})
    manifest.finalize(
        outcome,
        error=(None if outcome == "ok" else
               f"{counts['errors']} request error(s), {accounting['lost']} unaccounted"),
        metrics=metrics,
    )
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
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="deadline-hit-rate SLO objective")
    p.add_argument("--probe-every", type=float, default=0.0,
                   help="seconds between golden-probe runs on each engine (0 disables)")
    p.add_argument("--seed", type=int, default=0, help="weights (fresh init) and request pool")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    for flag in ("--layout-preset", "--compilation-cache-dir", "--attn-tune-cache"):
        item = flag[2:].replace("-", "_")
        p.add_argument(flag, default=None, help="not ported: ROADMAP " + NOT_CARRIED[item])
    fleet = p.add_argument_group("fleet mode")
    fleet.add_argument("--replicas", type=int, default=0,
                       help="N supervised engine replicas behind the router (0 = the single "
                            "in-process engine); prints the fleet line")
    fleet.add_argument("--inject-delay", default=None, metavar="RANK:SECONDS",
                       help="slow one replica by SECONDS per batch (the straggler arm)")
    fleet.add_argument("--shadow-rank", type=int, default=None,
                       help="mirror a sampled fraction of completed requests to this replica and "
                            "score top-1/logit agreement; it serves no routed traffic")
    fleet.add_argument("--shadow-frac", type=float, default=0.05,
                       help="fraction of admitted requests mirrored to the shadow rank")
    fleet.add_argument("--noise-weights", default=None, metavar="RANK:SCALE",
                       help="perturb one replica's float weights at load by SCALE x std")
    fleet.add_argument("--chaos-kill-rank", type=int, default=None,
                       help="SIGKILL this replica mid-load; the line carries the outage, the "
                            "restart and the routes after it")
    fleet.add_argument("--chaos-kill-at-frac", type=float, default=0.4,
                       help="kill after this fraction of the requests has been offered")
    fleet.add_argument("--chaos-recovery-timeout", type=float, default=180.0,
                       help="seconds to wait for the supervisor to restart the victim")
    fleet.add_argument("--probe-requests", type=int, default=16,
                       help="burst routed after a chaos recovery (0 disables)")
    fleet.add_argument("--fleet-workers", type=int, default=16,
                       help="router dispatch worker threads")
    fleet.add_argument("--router-refresh-secs", type=float, default=0.5,
                       help="router heartbeat-view refresh cadence")
    fleet.add_argument("--replica-startup-timeout", type=float, default=600.0,
                       help="seconds to wait for every replica endpoint + ping")
    fleet.add_argument("--max-restarts", type=int, default=2,
                       help="per-replica supervisor restart budget")
    fleet.add_argument("--restart-backoff", type=float, default=0.5,
                       help="per-replica supervisor backoff base seconds")
    return p


def validate(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """``sav_tpu``'s rules for the fleet options, and the refusals of what
    the port does not carry (``parser.error``: exit 2)."""
    refusal = not_carried(args)
    if refusal:
        p.error(refusal)
    if os.environ.get("SAV_LOCKWATCH"):
        p.error("SAV_LOCKWATCH (the runtime lock-order watch) is not ported yet: ROADMAP "
                "queue A11")
    if args.quant_weights and args.replicas:
        # The replicas are processes with their own engine configs; an
        # int8-labelled line served in bf16 would be a lie.
        p.error("--quant-weights is a single-engine arm; it does not compose with --replicas")
    if args.shadow_rank is not None:
        # A shadow needs one live rank to mirror FROM plus the shadow itself.
        if args.replicas < 2:
            p.error("--shadow-rank needs --replicas >= 2 (a live rank plus the mirrored shadow)")
        if not 0 <= args.shadow_rank < args.replicas:
            p.error("--shadow-rank must name one of the replica ranks")
    if args.noise_weights and not args.replicas:
        p.error("--noise-weights is a fleet chaos arm; it needs --replicas")
    if args.replicas and args.log_dir is None:
        args.log_dir = os.path.join("runs", "serve_fleet",
                                    f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}")


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    validate(p, args)
    out = run_fleet(args) if args.replicas else run(args)
    print(json.dumps(out))
    return 0 if out["outcome"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
