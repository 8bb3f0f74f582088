"""The port's run telemetry (sav_tpu_torch.obs, utils.writers, utils.debug,
utils.backend_probe) against sav_tpu's, on the CPU: each side fed the same
inputs, each side's files read by the other's readers; and the trainer's
telemetry in ``fit``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sav_tpu.obs import fleet as jax_fleet
from sav_tpu.obs import goodput as jax_goodput
from sav_tpu.obs import manifest as jax_manifest
from sav_tpu.obs import recorder as jax_recorder
from sav_tpu.obs import spans as jax_spans
from sav_tpu.obs import watchdog as jax_watchdog
from sav_tpu.train import supervisor as jax_supervisor
from sav_tpu.utils import debug as jax_debug
from sav_tpu.utils import writers as jax_writers
from sav_tpu_torch.data.synthetic import synth_resumable_iterator
from sav_tpu_torch.obs import fleet, goodput, manifest, recorder, spans, watchdog
from sav_tpu_torch.train import Checkpointer, Trainer, get_preset, supervisor
from sav_tpu_torch.utils import backend_probe, debug, writers


class FakeClock:
    def __init__(self, t0=1000.0):
        self.t = t0

    def __call__(self):
        return self.t


# ------------------------------------------------------------- recorder


def _batches():
    rng = np.random.default_rng(0)
    return {
        "float32": {"images": rng.standard_normal((2, 4, 4, 3)).astype(np.float32),
                    "labels": rng.integers(0, 10, (2,), dtype=np.int32)},
        "uint8": {"images": rng.integers(0, 256, (4, 4, 3, 2), dtype=np.uint8),
                  "labels": rng.integers(0, 10, (2,), dtype=np.int32)},
        "int32_labels_only": {"labels": np.arange(7, dtype=np.int32)},
        "mixed": {"images": rng.standard_normal((1, 2, 2, 3)).astype(np.float32),
                  "labels": np.array([3], np.int32), "mix_labels": np.array([1], np.int32),
                  "ratio": np.array([0.25], np.float32)},
    }


@pytest.mark.parametrize("kind", sorted(_batches()))
def test_batch_fingerprint_equals_sav_tpus(kind):
    batch = _batches()[kind]
    assert recorder.batch_fingerprint(batch) == jax_recorder.batch_fingerprint(batch)


def test_batch_fingerprint_of_the_synthetic_feed_equals_sav_tpus():
    from sav_tpu.data.synthetic import synth_batch as jax_synth_batch

    ours = next(synth_resumable_iterator(seed=3, start_step=4, batch_size=4, image_size=8))
    theirs = jax_synth_batch(seed=3, position=5, batch_size=4, image_size=8)
    assert recorder.batch_fingerprint(ours) == jax_recorder.batch_fingerprint(theirs)


def _metric_sequence():
    """Log windows: 10 healthy losses, a NaN episode of two windows, a
    recovery, a loss spike, and a host-only key that is not finite."""
    out = []
    for i in range(10):
        out.append({"loss": 2.0 - 0.01 * i + 0.001 * (i % 3), "grad_norm": 1.0,
                    "images_per_sec": 100.0})
    out.append({"loss": float("nan"), "grad_norm": 1.0})
    out.append({"loss": 1.8, "grad_norm": float("inf")})
    out.append({"loss": 1.9, "grad_norm": 1.0})
    out.append({"loss": 40.0, "grad_norm": 1.0})
    out.append({"loss": 1.85, "grad_norm": 1.0, "images_per_sec": float("inf")})
    return out


@pytest.mark.parametrize("spike_sigma", [6.0, 0.0])
def test_note_metrics_triggers_equal_sav_tpus(tmp_path, spike_sigma):
    ours = recorder.FlightRecorder(str(tmp_path / "a"), spike_sigma=spike_sigma, seed=0)
    theirs = jax_recorder.FlightRecorder(str(tmp_path / "b"), spike_sigma=spike_sigma, seed=0)
    got, want = [], []
    for step, metrics in enumerate(_metric_sequence(), start=1):
        ours.on_step(step)
        theirs.on_step(step)
        got.append(ours.note_metrics(step, metrics))
        want.append(theirs.note_metrics(step, metrics))
    assert got == want
    assert "nonfinite" in got and (("loss_spike" in got) == bool(spike_sigma))


def _recorded(tmp_path):
    """A port recorder that saw 6 steps of host batches (4 kept) and a
    snapshot of a small trainer's state at step 2, then dumped a nonfinite
    incident at step 6."""
    trainer = Trainer(get_preset("elastic_smoke"), device="cpu")
    state = trainer.init_state()
    rec = recorder.FlightRecorder(str(tmp_path), depth=8, keep_batches=4, seed=0,
                                  config={"seed": 0})
    place = rec.wrap_place(lambda b: b)
    batches = list(synth_resumable_iterator(seed=0, batch_size=2, image_size=8,
                                            num_batches=6))
    for step, batch in enumerate(batches, start=1):
        if step == 3:
            rec.snapshot(2, {k: v for k, v in state.state_dict().items()})
        place(batch)
        rec.on_step(step)
    path = rec.dump_incident("nonfinite", 6, error="FloatingPointError('x')")
    return rec, path, batches


def test_incident_bundle_reads_in_sav_tpus_readers(tmp_path):
    rec, path, batches = _recorded(tmp_path)
    assert path == str(tmp_path / "incidents" / "step_00000006")
    newest = jax_supervisor.newest_incident(str(tmp_path))
    assert newest["step"] == 6 and newest["trigger"] == "nonfinite"
    assert newest["path"] == path and newest["replayable"] is True
    assert newest["snapshot_step"] == 2 and newest["batch_steps"] == [3, 4, 5, 6]
    ring = {e["step"]: e for e in newest["ring"]}
    for step in (3, 4, 5, 6):
        got = jax_recorder.load_bundle_batch(path, step, ring[step]["batch"]["dtypes"])
        want = batches[step - 1]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        assert ring[step]["batch"]["hash"] == jax_recorder.batch_fingerprint(want)["hash"]
        ours = recorder.load_bundle_batch(path, step, ring[step]["batch"]["dtypes"])
        np.testing.assert_array_equal(ours["images"], want["images"])
    # The snapshot is a port checkpoint at the snapshot's step.
    snapshot = Checkpointer(os.path.join(path, "state"), read_only=True)
    saved = snapshot.restore_raw()
    assert snapshot.all_steps() == [2] and "params" in saved and "generators" in saved
    assert supervisor.newest_incident(str(tmp_path)) == newest


def test_snapshot_state_reuses_the_evicted_snapshots_buffers(tmp_path):
    """The trainer's snapshots: the third copy lands in the first's tensors
    (the recorder keeps two), holds the third state's values, and a
    bundle's state/ checkpoint holds the newest usable snapshot."""
    rec = recorder.FlightRecorder(str(tmp_path), depth=4, keep_batches=2, seed=0)
    trees = [{"params": {"w": torch.full((3, 2), float(i))}, "step": i,
              "opt_state": {"count": torch.tensor(i)}} for i in range(3)]
    for i, tree in enumerate(trees):
        rec.snapshot_state(i, tree, torch.device("cpu"))
    (s1, first), (s2, second) = list(rec._snapshots)
    assert (s1, s2) == (1, 2) and second["step"] == 2
    assert second["params"]["w"] is not trees[2]["params"]["w"]
    torch.testing.assert_close(second["params"]["w"], trees[2]["params"]["w"], rtol=0, atol=0)
    trees[2]["params"]["w"].add_(1.0)  # a copy, not a view of the state
    assert float(second["params"]["w"][0, 0]) == 2.0
    rec.snapshot_state(3, trees[0], torch.device("cpu"))
    assert list(rec._snapshots)[-1][1]["params"]["w"] is first["params"]["w"]
    assert float(first["params"]["w"][0, 0]) == 0.0 and int(first["opt_state"]["count"]) == 0
    assert rec.stats()["buffers_s"] > 0 and rec.stats()["snapshot_s"] > 0


# ---------------------------------------------------------------- fleet


def _write_streams(module, log_dir):
    """Three processes' heartbeats through ``module``'s writer, one slow
    on host stalls and one that never closes."""
    clock = FakeClock()
    ledger_cls = goodput.GoodputLedger if module is fleet else jax_goodput.GoodputLedger
    writers_ = []
    for proc in range(3):
        ledger = ledger_cls(clock=clock)
        hb = module.HeartbeatWriter(log_dir, process_index=proc, process_count=3, clock=clock)
        hb._host, hb._pid = "host", 100 + proc  # the same on both sides
        writers_.append((hb, ledger))
    for beat in range(1, 7):
        clock.t += 10.0
        for proc, (hb, ledger) in enumerate(writers_):
            ledger.account("step", 5.0)
            ledger.account("input_wait", 4.0 if proc == 2 else 0.5)
            ledger.steps += 4
            hb.beat(4 * beat, ledger=ledger,
                    metrics={"loss": 2.0 / beat, "images_per_sec": 100.0 + proc},
                    incident="incidents/step_00000008" if beat == 2 and proc == 1 else None)
    writers_[0][0].fleet_event("watchdog_soft", silent_s=12.5, at_step=24)
    writers_[0][0].close("ok")
    writers_[1][0].close("error")


def test_port_heartbeats_aggregate_as_sav_tpus(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _write_streams(fleet, str(ours))
    _write_streams(jax_fleet, str(theirs))
    for name in ("proc_0.jsonl", "proc_1.jsonl", "proc_2.jsonl"):
        assert (ours / "fleet" / name).read_text() == (theirs / "fleet" / name).read_text()
    assert jax_fleet.read_heartbeats(str(ours)) == fleet.read_heartbeats(str(ours))
    got = fleet.aggregate_fleet(str(ours), now=1070.0)
    want = jax_fleet.aggregate_fleet(str(ours), now=1070.0)
    got.pop("log_dir"), want.pop("log_dir")
    assert got == want
    assert got["straggler"]["straggler"] == 2 and got["events"][0]["event"] == "watchdog_soft"
    path = fleet.write_fleet_manifest(str(ours), fleet.aggregate_fleet(str(ours)))
    assert json.load(open(path))["processes"]["1"]["outcome"] == "error"


def test_read_heartbeats_skips_a_torn_tail_as_sav_tpus(tmp_path):
    _write_streams(fleet, str(tmp_path))
    with open(fleet.heartbeat_path(str(tmp_path), 2), "a") as f:
        f.write('{"kind": "hb", "step": 2')  # a SIGKILL mid-line
    assert fleet.read_heartbeats(str(tmp_path)) == jax_fleet.read_heartbeats(str(tmp_path))
    assert len(fleet.read_heartbeats(str(tmp_path))[2]) == 6


@pytest.mark.parametrize("env,expect", [
    ({}, (0, 1)), ({"SAV_FLEET_PROC": "2", "SAV_FLEET_PROCS": "4"}, (2, 4)),
    ({"SAV_FLEET_PROC": "x"}, (0, 1)), ({"SAV_FLEET_PROC": "3"}, (3, 4)),
])
def test_resolve_identity_equals_sav_tpus(monkeypatch, env, expect):
    for key in ("SAV_FLEET_PROC", "SAV_FLEET_PROCS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert fleet.resolve_identity(0, 1) == jax_fleet.resolve_identity(0, 1) == expect


# -------------------------------------------------------- goodput, spans


def _ledger_script(module):
    clock = FakeClock(0.0)
    ledger = module.GoodputLedger(clock=clock)
    clock.t = 2.0
    ledger.account("compile", 2.0)
    for i, seconds in enumerate([1.0, 1.1, 0.9, 9.0, 1.0, 1.05]):
        with ledger.measure("input_wait"):
            clock.t += 0.1
        clock.t += seconds
        ledger.note_window(2, seconds, step=2 * (i + 1))
    with ledger.measure("checkpoint"):
        clock.t += 0.7
    ledger.set_gauge("feeder/h2d_s", 0.25)
    clock.t += 0.3
    return ledger


def test_goodput_summary_equals_sav_tpus():
    ours, theirs = _ledger_script(goodput), _ledger_script(jax_goodput)
    assert ours.summary() == theirs.summary()
    assert ours.flat_metrics() == theirs.flat_metrics()
    assert ours.summary()["num_anomalies"] == 1
    assert goodput.BUCKETS == jax_goodput.BUCKETS


def test_span_trace_loads_as_sav_tpus(tmp_path):
    ours = spans.SpanTracer(str(tmp_path / "ours.json"))
    theirs = jax_spans.SpanTracer(str(tmp_path / "theirs.json"))
    for tracer in (ours, theirs):
        with tracer.span("step_dispatch", step=1):
            pass
        tracer.instant("stall_anomaly", step=1)
        tracer.write()
    a = json.load(open(tmp_path / "ours.json"))
    b = json.load(open(tmp_path / "theirs.json"))
    assert [(e["name"], e["ph"]) for e in a["traceEvents"]] == [
        (e["name"], e["ph"]) for e in b["traceEvents"]]
    assert a["displayTimeUnit"] == b["displayTimeUnit"]
    assert spans.SpanTracer(None).write() is None


# ------------------------------------------------------ manifest, writers


def _exceptions():
    class RetraceSanitizerError(RuntimeError):
        pass

    return [
        RetraceSanitizerError("step 3"), RuntimeError("RESOURCE_EXHAUSTED: Out of memory"),
        MemoryError(), ValueError("bad shape"), FloatingPointError("non-finite values in x"),
        RuntimeError("non-finite values in eval metrics"), ValueError("nan generated by sub"),
        KeyboardInterrupt(), RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    ]


@pytest.mark.parametrize("index", range(len(_exceptions())))
def test_classify_exception_equals_sav_tpus(index):
    exc = _exceptions()[index]
    assert manifest.classify_exception(exc) == jax_manifest.classify_exception(exc)


def test_classify_exception_names_the_torch_oom_and_nonfinite():
    assert manifest.classify_exception(torch.cuda.OutOfMemoryError("x")) == "oom"
    assert manifest.classify_exception(FloatingPointError("x")) == "nonfinite"
    assert manifest.OUTCOMES == jax_manifest.OUTCOMES


def test_run_manifest_loads_in_sav_tpus_reader(tmp_path):
    path = str(tmp_path / "run" / "manifest.json")
    m = manifest.RunManifest(path, kind="train", argv=["--synth-data"], config={"seed": 0})
    assert m.begin() == path
    assert jax_manifest.RunManifest.load(path)["outcome"] == "running"
    m.note("resume", {"from_step": 4})
    m.set_metrics({"goodput/step_s": 1.5})
    assert m.finalize("hang", error="stuck", exit_code=4)
    assert not m.finalize("ok", exit_code=0)  # first wins
    doc = jax_manifest.RunManifest.load(path)
    assert (doc["outcome"], doc["exit_code"], doc["kind"]) == ("hang", 4, "train")
    assert doc["notes"]["resume"] == {"from_step": 4} and doc["metrics"]["goodput/step_s"] == 1.5
    assert doc["env"]["torch"] == torch.__version__ and doc["schema"] == jax_manifest.MANIFEST_SCHEMA
    assert not [k for k in os.listdir(tmp_path / "run") if ".tmp" in k]


def test_jsonl_writer_equals_sav_tpus(tmp_path):
    records = [{"step": 2, "loss": np.float32(1.5), "images_per_sec": 10},
               {"step": 4, "summary": {"a": 1}, "note": "x"}]
    for module, name in ((writers, "ours"), (jax_writers, "theirs")):
        w = module.MultiWriter([module.JsonlWriter(str(tmp_path / name))])
        for r in records:
            w.write(r["step"], r)
        w.close()
    assert ((tmp_path / "ours" / "metrics.jsonl").read_text()
            == (tmp_path / "theirs" / "metrics.jsonl").read_text())
    lines = []
    writers.LoggingWriter(lines.append).write(3, {"loss": 0.5, "n": 2})
    jax_writers.LoggingWriter(lines.append).write(3, {"loss": 0.5, "n": 2})
    assert lines[0] == lines[1]


def test_find_nonfinite_equals_sav_tpus():
    tree = {"b": {"x": np.array([1.0, np.inf]), "y": np.array([1, 2])},
            "a": [np.float32(np.nan), np.ones(3, np.float32)], "c": 3.0}
    assert debug.find_nonfinite(tree) == jax_debug.find_nonfinite(tree) == ["a/0", "b/x"]
    metrics = {"loss": torch.tensor(float("nan")), "grad_norm": torch.tensor(1.0),
               "top_1_acc": torch.tensor(0.5, dtype=torch.bfloat16)}
    assert debug.find_nonfinite(metrics) == ["loss"]
    with pytest.raises(FloatingPointError, match=r"metrics at step 3: \['loss'\]"):
        debug.assert_all_finite(metrics, "metrics at step 3")


# -------------------------------------------------------------- watchdog


def test_watchdog_finalizes_hang_and_drains_the_checkpointer_before_exit(tmp_path):
    """The hard stage with an injected exit: the recorder's hang incident,
    the port Checkpointer's write in flight committed, the manifest
    finalized 'hang' (with the incident), then exit 4 — in that order."""
    trainer = Trainer(get_preset("elastic_smoke"), device="cpu")
    state = trainer.init_state()
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    m = manifest.RunManifest(str(tmp_path / "manifest.json"), kind="train")
    m.begin()
    rec = recorder.FlightRecorder(str(tmp_path), seed=0)
    rec.on_step(1)
    order, exited = [], threading.Event()
    wait = ckpt.wait

    def tracked_wait(timeout_s=None):
        done = wait(timeout_s)
        order.append(("drained", ckpt.all_steps()))
        return done

    ckpt.wait = tracked_wait

    def exit_fn(code):
        order.append(("exit", code, jax_manifest.RunManifest.load(m.path)["outcome"]))
        exited.set()

    ckpt.save(1, state)  # in flight when the watchdog fires
    dog = watchdog.HangWatchdog(0.3, poll_s=0.05, manifest=m, recorder=rec, checkpointer=ckpt,
                                exit_fn=exit_fn, stream=open(os.devnull, "w"))
    dog.start()
    assert exited.wait(10.0)
    dog.stop()
    del ckpt.wait
    ckpt.close()
    assert order == [("drained", [1]), ("exit", watchdog.WATCHDOG_EXIT_CODE, "hang")]
    doc = jax_manifest.RunManifest.load(m.path)
    assert doc["exit_code"] == 4 and doc["notes"]["incident"].endswith("step_00000001")
    assert jax_supervisor.newest_incident(str(tmp_path))["trigger"] == "hang"


def test_watchdog_soft_stage_then_hard_as_sav_tpus():
    fired = {}
    for name, module in (("ours", watchdog), ("theirs", jax_watchdog)):
        soft, done = [], threading.Event()
        dog = module.HangWatchdog(0.6, soft_deadline_s=0.2, poll_s=0.02, on_soft=soft.append,
                                  exit_fn=lambda code, done=done: done.set(),
                                  stream=open(os.devnull, "w"))
        dog.start()
        assert done.wait(10.0)
        dog.stop()
        fired[name] = (len(soft), dog.soft_count, dog.fired.is_set())
    assert fired["ours"] == fired["theirs"] == (1, 1, True)
    with pytest.raises(ValueError):
        watchdog.HangWatchdog(1.0, soft_deadline_s=1.0)


# ----------------------------------------------------------- backend probe


def test_backend_probe_finds_no_card_and_exits_3(tmp_path, monkeypatch):
    """With no CUDA device the probe subprocess reports none; the wait gives
    up at its deadline and the abort finalizes the manifest
    'backend_unreachable' with the probe timeline, exit 3."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert backend_probe.probe_backend(timeout_s=120.0) is None
    calls = []
    monkeypatch.setattr(backend_probe, "probe_backend",
                        lambda timeout_s, started=None: calls.append(timeout_s) or None)
    monkeypatch.setattr(backend_probe.time, "sleep", lambda s: None)
    m = manifest.RunManifest(str(tmp_path / "manifest.json"), kind="train")
    m.begin()
    with pytest.raises(SystemExit) as exit_info:
        backend_probe.require_backend_or_exit(0.5, tag="train", manifest=m)
    assert exit_info.value.code == 3 and calls
    doc = jax_manifest.RunManifest.load(m.path)
    assert (doc["outcome"], doc["exit_code"]) == ("backend_unreachable", 3)
    assert doc["notes"]["backend_probe"]["attempts"] == len(calls)
    monkeypatch.setattr(backend_probe, "probe_backend",
                        lambda timeout_s, started=None: "NVIDIA H100")
    m = manifest.RunManifest(str(tmp_path / "ok.json"), kind="train")
    assert backend_probe.require_backend_or_exit(5.0, tag="train", manifest=m) == "NVIDIA H100"
    assert jax_manifest.RunManifest.load(m.path)["notes"]["backend_probe"]["attempts"] == 1


# ------------------------------------------------------ the trainer's fit


def _fit(tmp_path, steps=6, feed=None, **kw):
    config = get_preset("elastic_smoke", global_batch_size=4, checkpoint_dir=str(tmp_path),
                        checkpoint_every_steps=2, **kw)
    trainer = Trainer(config, device="cpu")
    m = manifest.RunManifest(str(tmp_path / "manifest.json"), kind="train")
    m.begin()
    feed = feed if feed is not None else synth_resumable_iterator(
        seed=0, batch_size=4, image_size=32)
    return trainer, m, lambda: trainer.fit(feed, num_steps=steps, manifest=m)


@pytest.mark.parametrize("async_feed", [True, False])
def test_fit_writes_the_telemetry_files(tmp_path, async_feed):
    trainer, m, run = _fit(tmp_path, trace_spans=True, record=True, watchdog_secs=60.0,
                           async_feed=async_feed)
    state, history = run()
    assert state.step == 6 and [r["step"] for r in history] == [1, 2, 3, 4, 5, 6]
    good = json.load(open(tmp_path / "goodput.json"))
    assert good == trainer.last_goodput and good["steps"] == 6
    assert good["buckets_s"]["compile"] > 0 and good["buckets_s"]["step"] > 0
    assert good["buckets_s"]["checkpoint"] > 0 and "recorder/steps" in good["gauges"]
    names = {e["name"] for e in json.load(open(tmp_path / "spans.trace.json"))["traceEvents"]}
    fetch = {"batch_wait"} if async_feed else {"batch_fetch", "shard_batch"}
    assert fetch | {"step_dispatch", "log_sync", "checkpoint"} <= names
    beats = jax_fleet.read_heartbeats(str(tmp_path))[0]
    assert [b["step"] for b in beats if b["kind"] == "hb"] == [2, 4, 6]
    assert beats[-1] == {**beats[-1], "kind": "final", "outcome": "ok"}
    assert jax_fleet.aggregate_fleet(str(tmp_path))["processes"]["0"]["last_step"] == 6
    assert json.load(open(tmp_path / "fleet" / "fleet.json"))["processes"]["0"]["final"]
    notes = jax_manifest.RunManifest.load(m.path)["notes"]
    assert notes["backend"]["platform"] == "cpu" and notes["kernels"]["device"] == "cpu"
    assert notes["kernels"]["replays_at_step"] == 6
    metrics = jax_manifest.RunManifest.load(m.path)["metrics"]
    assert metrics["goodput/manifest/write_s"] > 0 and metrics["goodput/recorder/steps"] == 6
    assert notes["fleet"]["processes"]["0"]["heartbeats"] == 3
    assert not os.path.exists(tmp_path / "incidents")


def test_fit_without_fleet_or_sink_writes_no_telemetry(tmp_path, monkeypatch):
    config = get_preset("elastic_smoke", global_batch_size=4, fleet=False,
                        checkpoint_dir=str(tmp_path))
    Trainer(config, device="cpu").fit(
        synth_resumable_iterator(seed=0, batch_size=4, image_size=32), num_steps=2)
    assert not os.path.exists(tmp_path / "fleet")
    config = get_preset("elastic_smoke", global_batch_size=4, trace_spans=True, record=True)
    trainer = Trainer(config, device="cpu")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    trainer.fit(synth_resumable_iterator(seed=0, batch_size=4, image_size=32), num_steps=2)
    assert trainer.last_goodput["steps"] == 2 and os.listdir(cwd) == []


def _poisoned(at):
    for pos, batch in enumerate(synth_resumable_iterator(seed=0, batch_size=4, image_size=32),
                                start=1):
        if pos == at:
            batch = {**batch, "images": np.full_like(batch["images"], np.nan)}
        yield batch


def test_debug_nans_raises_before_the_log_boundarys_save(tmp_path):
    """A NaN at step 4, a log and save boundary: FloatingPointError at step
    4, no checkpoint of step 4 (the last committed is step 2), a nonfinite
    incident at step 4, the heartbeat stream closed 'error', goodput.json
    written on the way out."""
    trainer, m, run = _fit(tmp_path, feed=_poisoned(4), debug_nans=True, record=True)
    with pytest.raises(FloatingPointError, match="metrics at step 4"):
        run()
    assert Checkpointer(str(tmp_path), read_only=True).all_steps() == [2]
    incident = jax_supervisor.newest_incident(str(tmp_path))
    assert (incident["step"], incident["trigger"]) == (4, "nonfinite")
    assert jax_fleet.read_heartbeats(str(tmp_path))[0][-1]["outcome"] == "error"
    assert json.load(open(tmp_path / "goodput.json"))["steps"] == 2
    assert jax_manifest.RunManifest.load(m.path)["notes"]["incidents"][0]["step"] == 4


def test_recorder_dumps_a_nonfinite_window_without_debug_nans(tmp_path):
    trainer, m, run = _fit(tmp_path, feed=_poisoned(3), record=True, steps=4)
    state, history = run()
    assert not np.isfinite(history[3]["loss"])
    incident = jax_supervisor.newest_incident(str(tmp_path))
    assert (incident["step"], incident["trigger"]) == (4, "nonfinite")
    beats = [b for b in jax_fleet.read_heartbeats(str(tmp_path))[0] if b["kind"] == "hb"]
    assert beats[-1]["incident"] == incident["path"]


def test_fit_watchdog_fires_on_a_stalled_feed(tmp_path, monkeypatch):
    """A feed that stops yielding after step 3: the watchdog, armed after
    the first step, finalizes the manifest 'hang' and exits 4 (an injected
    exit here, which then releases the feed)."""
    release = threading.Event()
    exits = []

    def feed():
        for pos, batch in enumerate(synth_resumable_iterator(seed=0, batch_size=4,
                                                             image_size=32), start=1):
            if pos == 4:
                release.wait(20.0)
                return
            yield batch

    class Dog(watchdog.HangWatchdog):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs, exit_fn=lambda code: (exits.append(code),
                                                                   release.set()),
                             poll_s=0.05, stream=open(os.devnull, "w"))

    monkeypatch.setattr("sav_tpu_torch.train.telemetry.HangWatchdog", Dog)
    trainer, m, run = _fit(tmp_path, feed=feed(), watchdog_secs=0.5, record=True)
    t0 = time.perf_counter()
    state, _ = run()
    assert exits == [4] and state.step == 3 and time.perf_counter() - t0 < 20.0
    doc = jax_manifest.RunManifest.load(m.path)
    assert doc["outcome"] == "hang" and doc["exit_code"] == 4
    assert jax_supervisor.newest_incident(str(tmp_path))["trigger"] == "hang"


def test_a_torn_checkpoint_write_is_removed_and_never_counts(tmp_path):
    """A save killed before its rename leaves ``.N.tmp-…``: no reader takes
    it for a step, and the next writable Checkpointer removes it."""
    trainer, m, run = _fit(tmp_path, steps=2)
    run()
    torn = tmp_path / ".4.tmp-0123456789abcdef"
    torn.mkdir()
    (torn / "params.pt").write_bytes(b"half")
    for latest in (supervisor.latest_checkpoint_step, jax_supervisor.latest_checkpoint_step):
        assert latest(str(tmp_path)) == 2
    assert Checkpointer(str(tmp_path), read_only=True).all_steps() == [2]
    assert torn.exists()  # a reader leaves it
    Checkpointer(str(tmp_path)).close()
    assert not torn.exists() and (tmp_path / "2").is_dir()
