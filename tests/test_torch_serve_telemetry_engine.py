"""Serve telemetry end to end on the CPU: a tiny DeiT (two layers, width 64)
in the port's ``ServeEngine`` with a ``log_dir`` serves seeded requests;
the spans, the heartbeats, the final beat, the span ring's file and the
serve run manifest are checked, and ``sav_tpu``'s ``ServeEngine`` on the
same config and requests gives the same set of beat keys, the same
telemetry summary keys and the same counters (requests, traced, shed).
Counts and key sets are compared exactly; the heartbeat cadence is the
engine's own (0.1 s), the only waits."""

import json
import os
import time

import numpy as np
import pytest

from sav_tpu.obs import traceview
from sav_tpu.serve.batcher import QueueFullError as JaxQueueFullError
from sav_tpu_torch.obs import alerts
from sav_tpu_torch.serve.batcher import QueueFullError
from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
from sav_tpu_torch.serve.telemetry import (
    INTERVALS,
    STAGES,
    aggregate_serve,
    find_serve_manifests,
    read_serve_beats,
)

SMALL = dict(embed_dim=64, num_layers=2, num_heads=2, patch_shape=(8, 8))
REQUESTS = 8
SHED = 3
# A deadline no step can meet: admission sheds the request at submit (its
# projected dispatch wait is at least one measured step), on both sides.
INFEASIBLE_MS = 1e-3


def _config(module, log_dir, **kw):
    base = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                compute_dtype="float32", model_overrides=SMALL, buckets=[1, 4],
                max_queue=64, deadline_ms=60_000.0, log_dir=log_dir, heartbeat_secs=0.1)
    if module is ServeConfig:
        base["device"] = "cpu"
    base.update(kw)
    return module(**base)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _serve(engine, refused):
    """Full batches of 4 (no batch waits out its deadline), then the sheds;
    waits for the heartbeat thread's first beat, then stops."""
    before = engine.stats()
    with engine:
        futures = [engine.submit(img) for img in _images(REQUESTS)]
        for f in futures:
            f.result(timeout=60.0)
        for img in _images(SHED, seed=1):
            with pytest.raises(refused):
                engine.submit(img, deadline_ms=INFEASIBLE_MS)
        deadline = time.monotonic() + 10.0
        while engine.stats()["telemetry"]["heartbeats"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    return before


def _manifest(log_dir):
    names = [f for f in os.listdir(log_dir) if f.startswith("manifest-serve-")]
    assert len(names) == 1, names
    with open(os.path.join(log_dir, names[0])) as f:
        return json.load(f)


def test_engine_telemetry_end_to_end_and_against_sav_tpus_engine(tmp_path):
    from sav_tpu.serve.engine import ServeConfig as JaxServeConfig
    from sav_tpu.serve.engine import ServeEngine as JaxServeEngine

    port_dir = str(tmp_path / "port")
    engine = ServeEngine(_config(ServeConfig, port_dir))
    # Before admission opens, and before the first batch: no exception, no
    # percentile.
    before = _serve(engine, QueueFullError)
    assert before["live"]["p99_ms"] is None and before["live"]["requests"] == 0
    assert before["slo"]["hit_frac"] is None and before["slo"]["burning"] is False
    stats = engine.stop()
    assert stats["telemetry"]["requests"] == REQUESTS and stats["telemetry"]["shed"] == SHED
    assert stats["live"]["requests"] == REQUESTS and stats["live"]["shed"] == SHED
    assert stats["ledger"]["rejected"] == SHED
    telemetry = engine._telemetry

    # Every request's eight stamps, in STAGES order, monotone.
    records = telemetry.ring.records()
    assert len(records) == REQUESTS
    for rec in records:
        assert [s for s, _ in rec["stamps"]] == list(STAGES)
        times = [t for _, t in rec["stamps"]]
        assert times == sorted(times)
        assert set(rec["stages_ms"]) == {name for name, _, _ in INTERVALS}
        assert min(rec["stages_ms"].values()) >= 0.0
        assert rec["hit"] and rec["bucket"] == 4

    # Beats at the engine's cadence and the final beat on disk.
    beats = read_serve_beats(port_dir)[0]
    assert len(beats) == telemetry.stats()["heartbeats"] >= 2
    with open(os.path.join(port_dir, "fleet", "proc_0.jsonl")) as f:
        assert json.loads(f.read().splitlines()[-1])["kind"] == "final"
    last = beats[-1]
    assert last["requests"] == REQUESTS and last["shed"] == SHED
    assert last["dtype"] == "float32" and "capacity_rps" in last
    assert "hbm_bytes_in_use" not in last  # the CPU reports no device memory
    view = aggregate_serve(port_dir)["replicas"]["0"]
    assert view["requests"] == REQUESTS and view["final"] and view["p99_ms"] > 0
    assert view["queue_depth"] is not None and view["occupancy"] == 1.0

    # The serve run manifest: the three notes and the SLO (sheds are misses).
    doc = _manifest(port_dir)
    assert doc["kind"] == "serve" and doc["outcome"] == "ok"
    assert {"serve_startup", "serve_summary", "serve_telemetry"} <= set(doc["notes"])
    hit_frac = round(1.0 - SHED / (REQUESTS + SHED), 6)
    assert doc["metrics"]["serve/slo_hit_frac"] == hit_frac
    assert doc["metrics"]["serve/shed"] == float(SHED)
    assert doc["metrics"]["serve/requests"] == float(REQUESTS)
    assert doc["notes"]["serve_telemetry"]["traced"] == REQUESTS
    assert [m["kind"] for m in find_serve_manifests(port_dir)] == ["serve"]
    # The sheds burn the error budget 27 times over: the SLO rule fires once
    # and resolves at close.
    episodes = alerts.episodes(alerts.read_alerts(port_dir))
    assert episodes == {"slo-burn": {"fired": 1, "resolved": 1, "active": False,
                                     "severity": "page", "last_t": episodes["slo-burn"]["last_t"]}}
    assert doc["notes"]["alerts"]["episodes"] == {"slo-burn": 1}

    # The span ring's file, read by sav_tpu's traceview.
    ring = os.path.join(port_dir, "serve_traces", "requests_proc0.trace.json.gz")
    assert len(traceview.request_spans(traceview.load_trace(ring))) == REQUESTS

    # sav_tpu's engine on the same config and requests (its anomaly
    # profiler off: the port's waits in ROADMAP queue A10).
    jax_dir = str(tmp_path / "jax")
    jax_engine = JaxServeEngine(_config(JaxServeConfig, jax_dir, autoprof=False))
    _serve(jax_engine, JaxQueueFullError)
    jax_engine.stop()
    jax_beats = read_serve_beats(jax_dir)[0]
    # Beat keys, the quality fields included on both sides.
    keys = set().union(*(b.keys() for b in beats))
    jax_keys = set().union(*(b.keys() for b in jax_beats))
    assert "quality" in keys and keys == jax_keys
    assert set(telemetry.summary()) == set(jax_engine._telemetry.summary())
    for key in ("requests", "traced", "shed"):
        assert telemetry.summary()[key] == jax_engine._telemetry.summary()[key], key
    jax_doc = _manifest(jax_dir)
    assert "quality" in doc["notes"]
    assert set(doc["notes"]) >= set(jax_doc["notes"]) - {"layout"}
    assert doc["metrics"]["serve/slo_hit_frac"] == jax_doc["metrics"]["serve/slo_hit_frac"]
    assert doc["notes"]["alerts"]["episodes"] == jax_doc["notes"]["alerts"]["episodes"]


def test_an_engine_that_served_nothing_finalizes_an_honest_manifest(tmp_path):
    engine = ServeEngine(_config(ServeConfig, str(tmp_path), buckets=[1]))
    with engine:
        live = engine.stats()["live"]
        assert live["p99_ms"] is None and live["requests"] == 0
    doc = _manifest(str(tmp_path))
    assert doc["outcome"] == "ok"
    assert "serve/slo_hit_frac" not in doc["metrics"]
    assert "serve/p99_latency_ms" not in doc["metrics"]
    assert doc["metrics"]["serve/requests"] == 0.0


def test_telemetry_off_and_a_telemetry_that_cannot_start(tmp_path):
    engine = ServeEngine(_config(ServeConfig, None, buckets=[1], telemetry=False))
    with engine:
        assert engine.submit(_images(1)[0]).result(timeout=60.0).shape == (10,)
    stats = engine.stop()
    assert not {"live", "slo", "telemetry"} & set(stats)
    assert engine.manifest is None
    # A telemetry that fails to start raises; the engine is not built
    # without it.
    with pytest.raises(ValueError, match="slo target"):
        ServeEngine(_config(ServeConfig, str(tmp_path), buckets=[1], slo_target=1.5))


BENCH_ARGS = ["--device", "cpu", "--model", "vit_ti_patch16", "--num-classes", "10",
              "--image-size", "32", "--model-overrides", json.dumps(SMALL), "--max-batch", "4",
              "--deadline-ms", "30000", "--requests", "8"]


@pytest.mark.parametrize("arm", ["log_dir", "no_telemetry"])
def test_bench_line_telemetry_block(arm, tmp_path, capsys):
    """``--log-dir``: the line carries the telemetry block (the final beat
    counted, the layer's own cost, the directory), ``slo_hit_frac`` and the
    manifest written there; ``--no-telemetry``: neither the block nor
    ``slo_hit_frac``, and no files."""
    from sav_tpu_torch.serve import bench

    extra = (["--log-dir", str(tmp_path), "--heartbeat-secs", "30"] if arm == "log_dir"
             else ["--no-telemetry"])
    assert bench.main([*BENCH_ARGS, *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 8
    if arm == "log_dir":
        block = out["telemetry"]
        assert block["heartbeats"] == 1 and block["exemplars"] == 0
        assert block["log_dir"] == str(tmp_path) and 0.0 < block["overhead_s"] < 1.0
        assert out["slo_hit_frac"] == 1.0 and out["burn_rate"] == 0.0
        with open(out["manifest"]) as f:
            doc = json.load(f)
        assert doc["notes"]["metric"] == out["metric"] and doc["outcome"] == "ok"
        assert len(read_serve_beats(str(tmp_path))[0]) == 1
    else:
        assert not {"telemetry", "slo_hit_frac", "burn_rate", "manifest"} & set(out)
        assert os.listdir(tmp_path) == []
