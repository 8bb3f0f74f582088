"""The port's serve telemetry (``sav_tpu_torch.serve.telemetry``, the serve
half of ``obs/fleet.py``, the ledger's live window and the batcher's stamps)
against ``sav_tpu``'s on the CPU, with injected fake clocks and no sleeps:
the span records and their chrome-trace export (which ``sav_tpu``'s
``traceview`` parses from the port's file), the sliding and live windows,
the SLO burn arithmetic, ``ServeTelemetry``'s beats, summary, stats,
exemplars and alert events, and the offline readers on one log directory.
Every comparison is exact equality unless a test says otherwise; beat
records are compared without ``host`` and ``pid``."""

import gzip
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from sav_tpu.obs import fleet as jax_fleet
from sav_tpu.obs import traceview
from sav_tpu.serve import latency as jax_latency
from sav_tpu.serve import telemetry as jax_tele
from sav_tpu_torch.obs import fleet, rollup
from sav_tpu_torch.obs.manifest import RunManifest
from sav_tpu_torch.serve import latency
from sav_tpu_torch.serve import telemetry as tele
from sav_tpu_torch.serve.batcher import DynamicBatcher
from sav_tpu_torch.serve.bucketing import BucketLadder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = (("port", tele, fleet), ("jax", jax_tele, jax_fleet))


class FakeClock:
    def __init__(self, t=0.0, step=0.0):
        self.t = t
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t

    def advance(self, dt):
        self.t += dt


def _strip(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in ("host", "pid")}


# --------------------------------------------------------------- spans


def _walk(rng, t0):
    """One request's stage times after ``submit`` at ``t0``."""
    gaps = rng.exponential([1e-4, 2e-3, 3e-4, 1e-4, 4e-3, 1e-5, 2e-5])
    return list(zip(tele.STAGES[1:], t0 + np.cumsum(gaps)))


def test_vocabulary_and_span_records_equal_sav_tpus():
    assert tele.STAGES == jax_tele.STAGES
    assert tele.INTERVALS == jax_tele.INTERVALS
    assert tele.ROUTER_STAGES == jax_tele.ROUTER_STAGES
    assert tele.ROUTER_INTERVALS == jax_tele.ROUTER_INTERVALS
    rng = np.random.default_rng(0)
    for rid in range(20):
        t0 = float(rng.uniform(0, 100))
        walk = _walk(rng, t0)
        if rid % 5 == 4:
            walk = walk[:3]  # a request that never finished its walk
        traces = {}
        for name, mod, _ in SIDES:
            trace = mod.RequestTrace(rid, 0.05, t0)
            for stage, t in walk:
                mod.stamp(trace, stage, float(t))
            mod.stamp(None, "admit", 1.0)
            traces[name] = trace
        assert traces["port"].stamps == traces["jax"].stamps
        stages = tele.intervals(traces["port"].stamps)
        assert stages == jax_tele.intervals(traces["jax"].stamps)
        assert tele.dominant_stage(stages) == jax_tele.dominant_stage(stages)
        kw = dict(latency_s=float(walk[-1][1]) - t0, overrun_s=float(rng.normal(0, 0.01)),
                  bucket=8, batch_n=5)
        assert tele.trace_record(traces["port"], **kw) == jax_tele.trace_record(
            traces["jax"], **kw)
    assert tele.dominant_stage({}) is None
    ring = tele.SpanRing(3)
    for i in range(10):
        ring.append({"rid": i})
    assert len(ring) == 3 and ring.appended == 10
    assert [r["rid"] for r in ring.records()] == [7, 8, 9]
    with pytest.raises(ValueError):
        tele.SpanRing(0)


def _records(mod, n=12, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(1, n + 1):
        t0 = float(rng.uniform(0, 10))
        trace = mod.RequestTrace(rid, 0.03, t0)
        for stage, t in _walk(rng, t0):
            mod.stamp(trace, stage, float(t))
        rec = mod.trace_record(trace, latency_s=float(rng.uniform(0.001, 0.05)),
                               overrun_s=float(rng.normal(0, 0.01)), bucket=4, batch_n=3)
        rec["rank"] = rid % 2
        out.append(rec)
    return out


def test_chrome_export_equals_sav_tpus_and_traceview_parses_the_ports_file(tmp_path):
    port, jax = _records(tele), _records(jax_tele)
    assert port == jax
    for defs in (tele.INTERVALS, tele.ROUTER_INTERVALS):
        for kw in ({}, {"process_name": "Router", "extra_args": ("rank", "missing")}):
            assert tele.export_chrome_trace(port, defs, **kw) == jax_tele.export_chrome_trace(
                jax, defs, **kw)
    paths = {}
    for name, mod, _ in SIDES:
        path = str(tmp_path / name / "serve_traces" / "requests_proc0.trace.json.gz")
        assert mod.write_request_trace(path, port if name == "port" else jax) == path
        paths[name] = path
    docs = {}
    for name, path in paths.items():
        with gzip.open(path, "rt") as f:
            docs[name] = json.load(f)
    assert docs["port"] == docs["jax"]
    spans = traceview.request_spans(traceview.load_trace(paths["port"]))
    assert spans == traceview.request_spans(traceview.load_trace(paths["jax"]))
    assert sorted(spans) == list(range(1, 13))
    assert traceview.find_traces(str(tmp_path / "port")) == [paths["port"]]
    # An unwritable path degrades to None on both sides.
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert tele.write_request_trace(str(blocker / "a.trace.json.gz"), port) is None
    assert jax_tele.write_request_trace(str(blocker / "a.trace.json.gz"), jax) is None


# --------------------------------------------------------------- windows


@pytest.mark.parametrize("max_samples", [4096, 50])
def test_sliding_window_equals_sav_tpus(max_samples):
    rng = np.random.default_rng(3)
    clocks = {name: FakeClock() for name, _, _ in SIDES}
    windows = {name: mod.SlidingWindow(5.0, max_samples=max_samples, clock=clocks[name])
               for name, mod, _ in SIDES}
    for i in range(400):
        dt = float(rng.exponential(0.05 if i < 300 else 1.0))
        value = float(rng.lognormal(2.0, 0.7))
        for name in windows:
            clocks[name].advance(dt)
            windows[name].observe(value)
        if i % 7 == 0:
            now = clocks["port"].t + float(rng.uniform(0, 3))
            p, j = windows["port"], windows["jax"]
            assert p.values(now) == j.values(now)
            assert p.count(now) == j.count(now)
            assert p.total(now) == j.total(now)
            for q in (0.0, 50.0, 95.0, 99.0, 100.0):
                assert p.percentile(q, now) == j.percentile(q, now)
    assert windows["port"].percentile(99.0, clocks["port"].t + 100.0) is None
    for bad in ({"window_s": 0.0}, {"window_s": 1.0, "max_samples": 0}):
        with pytest.raises(ValueError):
            tele.SlidingWindow(**bad)


def _batches(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bucket = int(rng.choice([1, 2, 4, 8]))
        real = int(rng.integers(1, bucket + 1))
        lat = [float(v) for v in rng.lognormal(-4.5, 0.5, real)]
        if i in (n // 2, n // 2 + 1, n - 3):
            lat[0] *= 40.0  # a spike
        deadline = 0.03
        out.append({"dt": float(rng.exponential(0.3)), "bucket": bucket, "latencies": lat,
                    "overruns": [v - deadline for v in lat],
                    "queue_depth": int(rng.integers(0, 40)),
                    "step_s": float(rng.uniform(0.002, 0.01)),
                    "shed": int(rng.integers(0, 3)) if i % 9 == 0 else 0})
    return out


def test_live_window_snapshots_equal_sav_tpus():
    clocks = {name: FakeClock() for name, _, _ in SIDES}
    windows = {name: mod.LiveWindow(10.0, max_samples=200, clock=clocks[name])
               for name, mod, _ in SIDES}
    empty = windows["port"].snapshot()
    assert empty == windows["jax"].snapshot()
    assert empty["p99_ms"] is None and empty["requests"] == 0 and empty["occupancy"] is None
    for b in _batches(4):
        for name, window in windows.items():
            clocks[name].advance(b["dt"])
            window.observe_window(latencies_s=b["latencies"], overruns_s=b["overruns"],
                                  bucket=b["bucket"], queue_depth=b["queue_depth"],
                                  step_s=b["step_s"])
            if b["shed"]:
                window.observe_shed(b["shed"])
        assert windows["port"].snapshot() == windows["jax"].snapshot()
        now = clocks["port"].t + 4.0
        assert windows["port"].snapshot(now) == windows["jax"].snapshot(now)
        assert windows["port"].latency_values(now) == windows["jax"].latency_values(now)
        assert windows["port"].queue_values(now) == windows["jax"].queue_values(now)
    aged = windows["port"].snapshot(clocks["port"].t + 60.0)
    assert aged == windows["jax"].snapshot(clocks["jax"].t + 60.0)
    assert aged["requests"] == 0 and aged["p99_ms"] is None


def test_ledger_summary_bit_identical_with_the_window_on_and_off():
    """The ledger's final summary and flat metrics with the live window
    attached equal those without it, and ``sav_tpu``'s ledger's on the same
    observations; ``live()`` is None without a window."""
    ledgers = {}
    for name, window in (("off", None), ("on", tele.LiveWindow(10.0, clock=FakeClock()))):
        ledgers[name] = latency.LatencyLedger(clock=FakeClock(step=0.01), window=window)
    ledgers["jax"] = jax_latency.LatencyLedger(clock=FakeClock(step=0.01))
    for ledger in ledgers.values():
        ledger.start()
    for b in _batches(5):
        for ledger in ledgers.values():
            ledger.observe_batch(bucket=b["bucket"], latencies_s=b["latencies"],
                                 overruns_s=b["overruns"], queue_depth=b["queue_depth"],
                                 step_s=b["step_s"])
            if b["shed"]:
                ledger.observe_rejected(b["shed"])
    assert ledgers["on"].summary() == ledgers["off"].summary() == ledgers["jax"].summary()
    assert (ledgers["on"].flat_metrics() == ledgers["off"].flat_metrics()
            == ledgers["jax"].flat_metrics())
    assert ledgers["off"].live() is None
    live = ledgers["on"].live()
    assert live["requests"] > 0 and live["shed"] > 0


# ------------------------------------------------------------------- SLO


def test_slo_burn_arithmetic_equals_sav_tpus():
    rng = np.random.default_rng(6)
    clocks = {name: FakeClock() for name, _, _ in SIDES}
    trackers = {name: mod.SLOTracker(target=0.95, fast_window_s=30.0, slow_window_s=300.0,
                                     burn_threshold=1.5, clock=clocks[name])
                for name, mod, _ in SIDES}
    assert trackers["port"].state() == trackers["jax"].state()
    assert trackers["port"].state()["hit_frac"] is None
    burned = False
    for i in range(600):
        dt = float(rng.exponential(2.0))
        miss_p = 0.3 if 200 <= i < 320 else 0.01
        hits = [bool(rng.uniform() >= miss_p) for _ in range(int(rng.integers(0, 6)))]
        shed = int(rng.integers(1, 4)) if i % 23 == 0 else 0
        for name, tracker in trackers.items():
            clocks[name].advance(dt)
            for hit in hits:
                tracker.observe_request(hit)
            if shed:
                tracker.observe_outcomes(shed, shed)  # sheds are misses
            tracker.observe_outcomes(0, 0)  # nothing: a no-op
        state = trackers["port"].state()
        assert state == trackers["jax"].state()
        burned = burned or state["burning"]
    assert burned and not trackers["port"].state()["burning"]
    for bad in ({"target": 1.0}, {"target": 0.0}, {"fast_window_s": 600.0}):
        with pytest.raises(ValueError):
            tele.SLOTracker(**bad)


def test_sheds_count_as_slo_misses():
    telemetry = tele.ServeTelemetry(clock=FakeClock())
    telemetry.observe_shed(3)
    state = telemetry.slo.state()
    assert state["requests"] == 3 and state["misses"] == 3 and state["hit_frac"] == 0.0
    assert telemetry.summary()["shed"] == 3


# --------------------------------------------------------- ServeTelemetry


def _drive(mod, fleet_mod, log_dir, batches):
    clock, wall, perf = FakeClock(100.0), FakeClock(1.7e9), FakeClock(0.0, step=1e-6)
    writer = fleet_mod.HeartbeatWriter(log_dir, process_index=1, process_count=2, clock=wall,
                                       perf=perf)
    queue = {"queued": 0, "inflight": 0, "rejected": 0}
    telemetry = mod.ServeTelemetry(
        log_dir, dtype="bfloat16", trace_ring=64, exemplar_max=3, window_s=20.0,
        heartbeat_secs=0.0, slo_target=0.99, slo_fast_window_s=20.0, slo_slow_window_s=120.0,
        clock=clock, wall_clock=wall, perf=perf, writer=writer,
        queue_stats_fn=lambda: dict(queue),
        hbm_fn=lambda: {"hbm_bytes_in_use": 1.5e9, "hbm_peak_bytes": 2.5e9},
        max_batch=8)
    telemetry.start()
    rng = np.random.default_rng(9)
    for i, b in enumerate(batches):
        clock.advance(b["dt"])
        wall.advance(b["dt"])
        requests = []
        for lat in b["latencies"]:
            trace = telemetry.begin_trace(0.03)
            t0 = trace.stamps[0][1]
            for stage, t in _walk(rng, t0):
                mod.stamp(trace, stage, float(t))
            requests.append(SimpleNamespace(trace=trace))
        if i % 13 == 0:
            requests[0] = SimpleNamespace(trace=None)  # an untraced request
        formed = SimpleNamespace(requests=requests, bucket=b["bucket"],
                                 queue_depth=b["queue_depth"])
        telemetry.window.observe_window(latencies_s=b["latencies"], overruns_s=b["overruns"],
                                        bucket=b["bucket"], queue_depth=b["queue_depth"],
                                        step_s=b["step_s"])
        telemetry.observe_completed(formed, latencies_s=b["latencies"],
                                    overruns_s=b["overruns"], step_s=b["step_s"])
        if b["shed"]:
            telemetry.window.observe_shed(b["shed"])
            telemetry.observe_shed(b["shed"])
        queue.update(queued=b["queue_depth"], inflight=i % 3, rejected=i // 9)
        if i % 10 == 9:
            telemetry.serve_beat()
    summary = telemetry.close("ok")
    assert telemetry.close("ok") == telemetry.summary()  # idempotent
    return telemetry, summary


def _exemplar_docs(log_dir):
    root = os.path.join(log_dir, "serve_traces")
    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("slow_"):
            with open(os.path.join(root, name)) as f:
                out[name] = json.load(f)
    return out


def test_serve_telemetry_beats_summary_exemplars_and_alerts_equal_sav_tpus(tmp_path):
    batches = _batches(8)
    runs = {}
    for name, mod, fleet_mod in SIDES:
        runs[name] = _drive(mod, fleet_mod, str(tmp_path / name), batches)
    (port, port_summary), (jax, jax_summary) = runs["port"], runs["jax"]
    beats = {}
    for name, _, fleet_mod in SIDES:
        streams = fleet_mod.read_heartbeats(str(tmp_path / name))
        beats[name] = [_strip(r) for r in streams[1]]
    assert beats["port"] == beats["jax"]
    serve = [b for b in beats["port"] if b["kind"] == "serve"]
    assert len(serve) == len(batches) // 10 + 1 and beats["port"][-1]["kind"] == "final"
    assert {"capacity_rps", "hbm_bytes_in_use", "hbm_peak_bytes", "queued", "dtype",
            "alerts"} <= set(serve[-2]), serve[-2]
    # Exemplars: the same bundles, under the same names.
    port_ex, jax_ex = (_exemplar_docs(str(tmp_path / n)) for n in ("port", "jax"))
    assert list(port_ex) == list(jax_ex) and len(port_ex) == 3
    for key in port_ex:
        assert {k: v for k, v in port_ex[key].items() if k != "t_unix"} == {
            k: v for k, v in jax_ex[key].items() if k != "t_unix"}
        assert port_ex[key]["t_unix"] == jax_ex[key]["t_unix"]
    base = lambda paths: [os.path.basename(p) for p in paths]  # noqa: E731
    assert base(port_summary.pop("exemplars")) == base(jax_summary.pop("exemplars"))
    assert port_summary == jax_summary
    assert port_summary["alerts"]["episodes"].get("slo-burn", 0) >= 1
    assert port.stats() == jax.stats()
    assert port.ring.records() == jax.ring.records()
    # The alert events, byte for byte; the span ring's export, as JSON.
    with open(tmp_path / "port" / "fleet" / "alerts.jsonl", "rb") as a, \
            open(tmp_path / "jax" / "fleet" / "alerts.jsonl", "rb") as b:
        assert a.read() == b.read()
    docs = []
    for name in ("port", "jax"):
        with gzip.open(tmp_path / name / "serve_traces" / "requests_proc1.trace.json.gz",
                       "rt") as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]


def test_alert_rules_environment_seam(tmp_path, monkeypatch):
    rules = {"rules": [{"name": "p99-any", "metric": "w.p99_ms", "op": ">", "value": 0}]}
    monkeypatch.setenv("SAV_ALERT_RULES", json.dumps(rules))
    names = {}
    for name, mod, fleet_mod in SIDES:
        writer = fleet_mod.HeartbeatWriter(str(tmp_path / name))
        telemetry = mod.ServeTelemetry(str(tmp_path / name), writer=writer)
        names[name] = [r.name for r in telemetry.alerts.rules]
        telemetry.close()
    assert names["port"] == names["jax"] == [
        "slo-burn", "quality-churn", "quality-entropy-shift", "quality-probe-mismatch",
        "shadow-agreement", "p99-any"]
    assert tele.ServeTelemetry().alerts is None  # no writer: nothing armed


def test_heartbeat_thread_beats_at_its_cadence(tmp_path):
    """The thread's own cadence (0.05 s), then the final beat at close."""
    writer = fleet.HeartbeatWriter(str(tmp_path))
    telemetry = tele.ServeTelemetry(str(tmp_path), writer=writer, heartbeat_secs=0.05)
    telemetry.start()
    deadline = threading.Event()
    for _ in range(100):
        if telemetry.stats()["heartbeats"] >= 2:
            break
        deadline.wait(0.05)
    telemetry.close()
    stream = fleet.read_heartbeats(str(tmp_path))[0]
    assert sum(r["kind"] == "serve" for r in stream) == telemetry.stats()["heartbeats"] >= 3
    assert stream[-1]["kind"] == "final"


# ------------------------------------------------------- the serve beats


def test_serve_beat_lines_drops_and_tail_reads_equal_sav_tpus(tmp_path):
    writers = {}
    for name, _, fleet_mod in SIDES:
        writers[name] = fleet_mod.HeartbeatWriter(
            str(tmp_path / name), process_index=2, process_count=3,
            clock=FakeClock(1.7e9, step=1.25), perf=FakeClock(step=1e-6))
    for i in range(40):
        payload = {"requests": i, "w": {"p99_ms": 1.5 * i}, "slo": {"burn_rate": 0.1 * i}}
        kind = "router" if i % 10 == 3 else "serve"
        assert (writers["port"].serve_beat(payload, kind=kind)
                is writers["jax"].serve_beat(payload, kind=kind) is True)
    # A wedged writer drops the beat (False), never blocks.
    for w in writers.values():
        w.LOCK_TIMEOUT_S = 0.01
        w._lock.acquire()
    assert writers["port"].serve_beat({"x": 1}) is False
    assert writers["jax"].serve_beat({"x": 1}) is False
    for w in writers.values():
        w._lock.release()
        w.close("ok")
    # Nothing is written after close.
    assert writers["port"].serve_beat({"x": 2}) is False
    assert writers["port"].stats()["dropped"] == 1.0
    assert _strip_stats(writers["port"]) == _strip_stats(writers["jax"])
    files = [tmp_path / name / "fleet" / "proc_2.jsonl" for name in ("port", "jax")]
    lines = [[_strip(json.loads(l)) for l in f.read_text().splitlines()] for f in files]
    assert lines[0] == lines[1] and len(lines[0]) == 41
    # tail_bytes: the live readers' bounded read, on either side's file.
    size = files[0].stat().st_size
    for tail in (None, 0, 1, 150, 1000, size - 1, size, 10 * size):
        for d in ("port", "jax"):
            got = fleet.read_heartbeats(str(tmp_path / d), tail_bytes=tail)
            assert got == jax_fleet.read_heartbeats(str(tmp_path / d), tail_bytes=tail)
    assert fleet.read_heartbeats(str(tmp_path / "port"), tail_bytes=0) == {2: []}


def _strip_stats(writer):
    return {k: v for k, v in writer.stats().items() if k != "write_s"}


# ------------------------------------------------------- offline readers


def _fleet_dir(tmp_path, *, roll: bool):
    """Two replicas' beat streams (one closed with a final record, one
    still beating), exemplars and manifests in one log directory."""
    log_dir = str(tmp_path)
    batches = _batches(11, n=60)
    for proc in (0, 1):
        wall = FakeClock(1.7e9 + 3.0 * proc)
        writer = fleet.HeartbeatWriter(log_dir, process_index=proc, process_count=2,
                                       clock=wall)
        telemetry = tele.ServeTelemetry(
            log_dir, writer=writer, clock=FakeClock(), wall_clock=wall, heartbeat_secs=0.0,
            max_batch=8, exemplar_max=2, queue_stats_fn=lambda: {"queued": 3, "inflight": 1})
        rng = np.random.default_rng(proc)
        for i, b in enumerate(batches):
            wall.advance(b["dt"] * 10)
            telemetry.clock.advance(b["dt"] * 10)
            requests = [SimpleNamespace(trace=telemetry.begin_trace(0.03))
                        for _ in b["latencies"]]
            for r in requests:
                for stage, t in _walk(rng, r.trace.stamps[0][1]):
                    tele.stamp(r.trace, stage, float(t))
            telemetry.window.observe_window(latencies_s=b["latencies"],
                                            overruns_s=b["overruns"], bucket=b["bucket"],
                                            queue_depth=b["queue_depth"], step_s=b["step_s"])
            telemetry.observe_completed(SimpleNamespace(requests=requests, bucket=b["bucket"],
                                                        queue_depth=b["queue_depth"]),
                                        latencies_s=b["latencies"], overruns_s=b["overruns"],
                                        step_s=b["step_s"])
            if i % 6 == 5:
                telemetry.serve_beat()
        if proc == 0:
            telemetry.close()
    for kind, name in (("serve", "manifest-serve-1.json"), ("train", "manifest.json")):
        RunManifest(os.path.join(log_dir, name), kind=kind, config={"k": kind}).begin()
    with open(os.path.join(log_dir, "manifest-torn.json"), "w") as f:
        f.write("{")
    with open(os.path.join(log_dir, "serve_traces", "slow_9999_torn.json"), "w") as f:
        f.write("{")
    if roll:
        rollup.roll(log_dir, flush=True)
    return log_dir


@pytest.mark.parametrize("roll", [False, True], ids=["beats", "rolled"])
def test_offline_readers_equal_sav_tpus(tmp_path, roll):
    log_dir = _fleet_dir(tmp_path, roll=roll)
    assert tele.read_serve_beats(log_dir) == jax_tele.read_serve_beats(log_dir)
    for kw in ({}, {"now": 1.7e9 + 5000.0}, {"max_timeline": 5, "suspect_factor": 1.5},
               {"tail_bytes": 2000}):
        assert tele.aggregate_serve(log_dir, **kw) == jax_tele.aggregate_serve(log_dir, **kw)
    view = tele.aggregate_serve(log_dir)
    assert set(view["replicas"]) == {"0", "1"} and view["replicas"]["0"]["final"]
    assert view["fleet"]["capacity_rps"] > 0 and "headroom_frac" in view["fleet"]
    late = tele.aggregate_serve(log_dir, now=1.7e9 + 1e5)
    assert late["fleet"]["suspects"] == [1]
    for kw in ({"now": 1.7e9 + 100.0}, {"now": 1.7e9 + 1e5, "tail_bytes": None}):
        assert tele.router_views(log_dir, **kw) == jax_tele.router_views(log_dir, **kw)
    found = tele.find_exemplars(log_dir)
    assert found == jax_tele.find_exemplars(log_dir) and len(found) >= 2
    manifests = tele.find_serve_manifests(log_dir)
    assert manifests == jax_tele.find_serve_manifests(log_dir)
    assert [os.path.basename(m["path"]) for m in manifests] == ["manifest-serve-1.json"]
    assert list(fleet.iter_manifests(log_dir)) == list(jax_fleet.iter_manifests(log_dir))
    assert tele.aggregate_serve(str(tmp_path / "none")) == jax_tele.aggregate_serve(
        str(tmp_path / "none"))


# ----------------------------------------------------------- structural


def test_the_telemetry_and_batcher_import_neither_torch_nor_numpy():
    """In a fresh interpreter: the stamping, window, SLO, alert and rollup
    modules and the batcher load no torch and no numpy, so no device sync
    can be reached from them."""
    code = (
        "import sys\n"
        "import sav_tpu_torch.serve.telemetry, sav_tpu_torch.serve.batcher\n"
        "import sav_tpu_torch.serve.latency, sav_tpu_torch.obs.alerts\n"
        "import sav_tpu_torch.obs.rollup, sav_tpu_torch.obs.memory\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout


def test_batcher_stamps_admit_and_batch_formed_under_a_fake_clock():
    clock = FakeClock()
    telemetry = tele.ServeTelemetry(clock=clock)
    batcher = DynamicBatcher(BucketLadder([1, 2]), step_time_fn=lambda b: 0.0,
                             default_deadline_s=1.0, clock=clock)
    traces = []
    for _ in range(2):
        trace = telemetry.begin_trace(1.0)
        traces.append(trace)
        batcher.submit("x", trace=trace)
        clock.advance(0.01)
    batcher.submit("untraced")  # no trace: nothing to stamp, no error
    formed = batcher.next_batch()
    assert len(formed.requests) == 2
    for trace in traces:
        assert [s for s, _ in trace.stamps] == ["submit", "admit", "batch_formed"]
        times = [t for _, t in trace.stamps]
        assert times == sorted(times)
        assert trace.stamps[1][1] == trace.stamps[0][1]  # admit at submit's instant
    assert {t for trace in traces for s, t in trace.stamps if s == "batch_formed"} == {
        formed.formed_t}
    assert [r.trace for r in formed.requests] == traces
    clock.advance(2.0)  # past the lone request's deadline: the drain ships it
    assert batcher.next_batch().requests[0].trace is None
    batcher.close()
