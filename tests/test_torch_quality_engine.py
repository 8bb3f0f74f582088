"""The port's ServeEngine with its prediction-quality wiring, on the CPU,
against sav_tpu's engine: a small ViT (2 layers, width 64, 2 heads, 32²
images, patch 8, 10 classes) with the same flax weights on both sides.

- The serving programs' digests agree on the same batches: ``top1`` where
  sav_tpu separates the first two classes by more than twice the logits
  tolerance, ``margin`` and ``entropy`` within the f32 logits tolerance
  (2e-5); the engines' quality windows see the same rows.
- A beat carries ``quality``, the manifest ``notes.quality`` and, once a
  probe ran, ``serve/probe_ok_frac``.
- The golden probe: it sheds while live work is queued, holds on a rerun
  and from a second engine on the same parameters, mismatches under
  ``SAV_CHAOS_NOISE_WEIGHTS`` with exactly one ``quality-probe-mismatch``
  episode, keys an int8 engine's reference ``<probe_id>:int8``, and runs on
  its own thread at ``probe_every_s``. The probe's id is sav_tpu's.
"""

import json
import os
import time

import jax
import numpy as np
import pytest

from sav_tpu.serve import quality as jax_serve_quality
from sav_tpu.serve.engine import ServeConfig as JaxServeConfig
from sav_tpu.serve.engine import ServeEngine as JaxServeEngine
from sav_tpu_torch.obs import alerts
from sav_tpu_torch.serve import quality as serve_quality
from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
from sav_tpu_torch.serve.telemetry import read_serve_beats
from test_torch_vit import SMALL, small_flax_params

LOGITS_TOL = 2e-5


@pytest.fixture(scope="module")
def flax_params():
    return small_flax_params()


def _config(module, **kw):
    base = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                compute_dtype="float32", model_overrides=SMALL, buckets=[4],
                max_queue=64, deadline_ms=60_000.0)
    if module is ServeConfig:
        base["device"] = "cpu"
    base.update(kw)
    return module(**base)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _manifest(log_dir):
    (name,) = [f for f in os.listdir(log_dir) if f.startswith("manifest")]
    with open(os.path.join(log_dir, name)) as f:
        return json.load(f)


def test_digests_agree_with_sav_tpus_engine(flax_params):
    import torch

    port = ServeEngine(_config(ServeConfig, buckets=[4]), params=flax_params)
    jax_engine = JaxServeEngine(_config(JaxServeConfig, buckets=[4]), params=flax_params)
    separated = 0
    for seed in range(4):
        images = _images(4, seed=seed)
        valid = np.array([1, 1, 1, 0 if seed % 2 else 1], np.float32)
        got = port.infer_fn(torch.from_numpy(images), torch.from_numpy(valid))
        got = {k: v.numpy() for k, v in got.items()}
        want = jax.device_get(jax_engine._executables[4](
            jax_engine._params, jax_engine._batch_stats,
            {"images": images, "valid": valid}))
        assert set(got) == set(want) == {"logits", "top1", "margin", "entropy"}
        np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        np.testing.assert_allclose(got["margin"], want["margin"], atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        np.testing.assert_allclose(got["entropy"], want["entropy"], atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        top2 = np.sort(want["logits"], axis=-1)
        clear = (top2[:, -1] - top2[:, -2]) > 2 * LOGITS_TOL
        np.testing.assert_array_equal(got["top1"][clear], want["top1"][clear])
        separated += int(clear.sum())
        assert (got["top1"][valid == 0] == 0).all() and (got["entropy"][valid == 0] == 0).all()
    assert separated >= 12
    # Served through both engines: the windows see the same rows.
    snaps = []
    for engine in (port, jax_engine):
        with engine:
            futures = [engine.submit(img) for img in _images(8, seed=9)]
            for f in futures:
                f.result(timeout=60.0)
        snaps.append(engine.stats()["quality"])
        engine.stop()
    assert snaps[0]["n"] == snaps[1]["n"] == 8 and snaps[0]["seen"] == 8
    assert snaps[0]["entropy_med"] == pytest.approx(snaps[1]["entropy_med"], abs=1e-4)
    assert snaps[0]["margin_med"] == pytest.approx(snaps[1]["margin_med"], abs=1e-4)
    assert snaps[0]["probe_runs"] == snaps[1]["probe_runs"] == 0


def test_beats_and_manifest_carry_quality(tmp_path, flax_params):
    log_dir = str(tmp_path)
    engine = ServeEngine(_config(ServeConfig, log_dir=log_dir, heartbeat_secs=0.1),
                         params=flax_params)
    with engine:
        for f in [engine.submit(img) for img in _images(8)]:
            f.result(timeout=60.0)
        deadline = time.monotonic() + 5.0
        while engine.stats()["telemetry"]["heartbeats"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    beats = [b for b in read_serve_beats(log_dir)[0] if b.get("kind") == "serve"]
    assert beats and all(b["quality"]["n"] == 8 for b in beats[-1:])
    assert set(beats[-1]["quality"]) >= {"n", "seen", "entropy_med", "margin_med",
                                        "probe_runs", "probe_ok", "probe_mismatch",
                                        "probe_shed"}
    doc = _manifest(log_dir)
    assert doc["notes"]["quality"]["n"] == 8
    assert "serve/probe_ok_frac" not in doc["metrics"]  # no probe ran: skipped


def _probe(engine, log_dir):
    runner = serve_quality.ProbeRunner(engine, engine._probe_ledger, every_s=999,
                                       log_dir=log_dir)
    return runner, runner.observe_probe()


def test_probe_holds_across_runs_and_engines_and_sheds_first(tmp_path, flax_params):
    log_dir = str(tmp_path)
    engine = ServeEngine(_config(ServeConfig, log_dir=log_dir, heartbeat_secs=0.1),
                         params=flax_params)
    with engine:
        runner = serve_quality.ProbeRunner(engine, engine._probe_ledger, every_s=999,
                                           log_dir=log_dir)
        assert runner.probe_id == jax_serve_quality.make_probe_batch(32)[1]
        assert runner.key == f"{runner.probe_id}:float32"
        # Shed first: queued live work sheds the probe.
        real_stats = engine._batcher.stats
        engine._batcher.stats = lambda: {"queued": 2, "inflight": 0}
        assert runner.observe_probe() is None
        engine._batcher.stats = real_stats
        assert engine._probe_ledger.shed == 1
        # The first run freezes the reference; reruns reproduce its bits.
        assert runner.observe_probe() is True
        reference = serve_quality.load_reference(log_dir)
        assert reference == {runner.key: engine._probe_ledger.last}
        assert runner.observe_probe() is True
        # A planted wrong reference: the next run mismatches.
        with open(os.path.join(log_dir, "fleet", "probe_reference.json"), "w") as f:
            json.dump({runner.key: "deadbeef"}, f)
        assert runner.observe_probe() is False
        snap = engine._probe_ledger.snapshot()
        assert snap["probe_mismatch"] == 1 and snap["probe_expected"] == "deadbeef"
        assert snap["probe_ok_frac"] == pytest.approx(2 / 3)
    engine.stop()
    beats = [b for b in read_serve_beats(log_dir)[0] if isinstance(b.get("quality"), dict)]
    assert beats[-1]["quality"]["probe_mismatch"] == 1
    assert beats[-1]["quality"]["probe_fingerprint"] == reference[runner.key]
    doc = _manifest(log_dir)
    assert doc["notes"]["quality"]["probe_mismatch"] == 1
    assert doc["metrics"]["serve/probe_ok_frac"] == pytest.approx(2 / 3)
    # A second engine on the same parameters, a fresh reference file with the
    # first engine's bits: the probe holds.
    second_dir = str(tmp_path / "second")
    serve_quality.store_reference(second_dir, runner.key, reference[runner.key])
    with ServeEngine(_config(ServeConfig), params=flax_params) as second:
        assert _probe(second, second_dir)[1] is True
    second.stop()


def test_noised_weights_mismatch_with_one_alert_episode(tmp_path, flax_params, monkeypatch):
    log_dir = str(tmp_path)
    with ServeEngine(_config(ServeConfig), params=flax_params) as clean:
        runner, ok = _probe(clean, log_dir)  # freezes the clean reference
        assert ok is True
    clean.stop()
    monkeypatch.setenv("SAV_CHAOS_NOISE_WEIGHTS", "0.5")
    engine = ServeEngine(_config(ServeConfig, log_dir=log_dir, heartbeat_secs=0.1),
                         params=flax_params)
    with engine:
        assert _probe(engine, log_dir)[1] is False
        assert _probe(engine, log_dir)[1] is False  # the counter grows: still one episode
        deadline = time.monotonic() + 5.0
        while engine.stats()["telemetry"]["heartbeats"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    engine.stop()
    assert engine._probe_ledger.snapshot()["probe_mismatch"] == 2
    episodes = alerts.episodes(alerts.read_alerts(log_dir))
    assert set(episodes) == {"quality-probe-mismatch"}
    assert episodes["quality-probe-mismatch"]["fired"] == 1
    assert episodes["quality-probe-mismatch"]["resolved"] == 1
    assert _manifest(log_dir)["notes"]["alerts"]["episodes"] == {"quality-probe-mismatch": 1}


def test_int8_engine_keys_its_own_reference_and_the_thread_probes(tmp_path):
    log_dir = str(tmp_path)
    config = _config(ServeConfig, quant_weights=True, log_dir=log_dir, heartbeat_secs=0.1,
                     probe_every_s=0.05)
    engine = ServeEngine(config)
    assert engine.startup_report["dtype"] == "int8"
    with engine:
        deadline = time.monotonic() + 20.0
        while (engine._probe_ledger.snapshot()["probe_ok"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
    engine.stop()
    snap = engine.stats()["quality"]
    assert snap["probe_ok"] >= 2 and snap["probe_mismatch"] == 0
    probe_id = jax_serve_quality.make_probe_batch(32)[1]
    assert list(serve_quality.load_reference(log_dir)) == [f"{probe_id}:int8"]
    assert _manifest(log_dir)["metrics"]["serve/probe_ok_frac"] == 1.0
