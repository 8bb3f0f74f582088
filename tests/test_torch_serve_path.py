"""The port's serving path around the captured programs, on the CPU.

- ``serve/preprocess.py`` bit-equal to ``sav_tpu.serve.preprocess`` on
  seeded decoded images of several shapes, with the same validation errors;
  ``normalize_images`` bit-equal to ``sav_tpu``'s in f32 and bf16.
- ``data/feeder.py``: the ``DeviceFeeder`` cases of tests/test_feeder.py's
  unit tier, ordered by events rather than sleeps.
- The engine: the feeder places batch N+1 while batch N is held in
  ``execute_hook``; ``drain``; a failed placement or execution; a port
  checkpoint served through ``checkpoint_dir`` bit-equal to the trained
  module without opening the optimizer file; raw images through
  ``submit_raw`` against ``sav_tpu``'s ``preprocess_request`` and
  ``build_infer_fn``.
- ``python -m sav_tpu_torch.serve.bench --device cpu``.

No test asserts a wall-clock ratio.
"""

import copy
import gc
import json
import os
import subprocess
import sys
import threading
import weakref
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.ops.preprocess import normalize_images as jax_normalize_images
from sav_tpu.serve import preprocess as jax_preprocess
from sav_tpu.serve.engine import build_infer_fn as jax_build_infer_fn
from sav_tpu_torch.data.feeder import DeviceFeeder
from sav_tpu_torch.data.synthetic import synth_resumable_iterator
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import BatchNorm
from sav_tpu_torch.ops.preprocess import normalize_images
from sav_tpu_torch.serve import bench
from sav_tpu_torch.serve import preprocess
from sav_tpu_torch.serve.batcher import ServeClosedError
from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
from sav_tpu_torch.serve.graphs import BucketGraphs
from sav_tpu_torch.train import TrainConfig, Trainer
from sav_tpu_torch.train.checkpoint import OPT_STATE_FILE, PARAMS_FILE
from sav_tpu_torch.utils.graphs import POOL_STREAMS, held_stream, streams_held
from test_torch_vit import SMALL, small_flax_params, small_port_model

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4  # tests/test_torch_serve.py's, f32 logits of the small ViT
TINY = dict(embed_dim=16, num_layers=1, num_heads=2, patch_shape=(8, 8))


def _config(**kw):
    base = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                compute_dtype="float32", model_overrides=SMALL, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


def _images(n, seed=0, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# ------------------------------------------------------ preprocessing


# (height, width, image_size): a wide photo to 224, odd sizes to 48, a
# square, and one narrower than tall.
SHAPES = [(300, 451, 224), (97, 131, 48), (64, 64, 48), (211, 120, 48)]


@pytest.mark.parametrize("height,width,size", SHAPES)
def test_preprocess_request_is_bit_equal_to_sav_tpu(height, width, size):
    image = np.random.default_rng(height * width).integers(
        0, 256, (height, width, 3), dtype=np.uint8)
    assert preprocess.center_crop_window(height, width, size) == \
        jax_preprocess.center_crop_window(height, width, size)
    got = preprocess.preprocess_request(image, size)
    want = jax_preprocess.preprocess_request(image, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(preprocess.resize_bicubic_u8(image, size),
                                  jax_preprocess.resize_bicubic_u8(image, size))


@pytest.mark.parametrize("image,size,match", [
    (np.zeros((32, 32), np.uint8), 32, "decoded"),
    (np.zeros((32, 32, 4), np.uint8), 32, "decoded"),
    (np.zeros((64, 64, 3), np.float32), 32, "uint8"),
    (np.zeros((1, 1, 3), np.uint8), 224, "too small"),
])
def test_preprocess_request_refuses_what_sav_tpu_refuses(image, size, match):
    with pytest.raises(ValueError, match=match) as got:
        preprocess.preprocess_request(image, size)
    with pytest.raises(ValueError) as want:
        jax_preprocess.preprocess_request(image, size)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_images_is_bit_equal_to_sav_tpu(dtype):
    images = _images(3, seed=7, size=16)
    got = normalize_images(torch.from_numpy(images), getattr(torch, dtype))
    want = jax_normalize_images(jnp.asarray(images), getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_bucket_graphs_need_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        BucketGraphs(lambda images, valid: images, [1], 32, torch.device("cpu"))


class _Pool:
    """PyTorch's stream pool as held_stream sees it: ``pointers`` handed
    out round robin, each draw counted."""

    def __init__(self, pointers):
        self.pointers, self.draws = pointers, 0

    def __call__(self, device):
        self.draws += 1
        return SimpleNamespace(cuda_stream=self.pointers[(self.draws - 1) % len(self.pointers)])


class _Owner:
    pass


def test_held_stream_skips_a_stream_a_live_owner_holds():
    # A device of its own keeps the module's record of other tests apart.
    device, pool = torch.device("cuda", 101), _Pool([1, 1, 2, 2, 3])
    a, b = _Owner(), _Owner()
    first = held_stream(device, a, new_stream=pool)
    second = held_stream(device, b, new_stream=pool)
    assert (first.cuda_stream, second.cuda_stream) == (1, 2)
    assert streams_held() >= 2


def test_held_stream_of_a_collected_owner_goes_to_the_next():
    device, pool = torch.device("cuda", 102), _Pool(list(range(1, POOL_STREAMS + 1)))
    a, b = _Owner(), _Owner()
    freed = held_stream(device, a, new_stream=pool)
    kept = held_stream(device, b, new_stream=pool)
    del a
    gc.collect()
    draws, c = pool.draws, _Owner()
    assert held_stream(device, c, new_stream=pool) is freed
    assert pool.draws == draws  # reused, not drawn
    assert held_stream(device, b, new_stream=pool).cuda_stream not in (freed.cuda_stream,
                                                                        kept.cuda_stream)


def test_held_stream_raises_when_every_pool_stream_is_held():
    device, pool = torch.device("cuda", 103), _Pool(list(range(1, POOL_STREAMS + 1)))
    owners = [_Owner() for _ in range(POOL_STREAMS)]
    assert len({held_stream(device, o, new_stream=pool).cuda_stream for o in owners}) == POOL_STREAMS
    with pytest.raises(RuntimeError, match="held by a live owner"):
        held_stream(device, _Owner(), new_stream=pool)
    del owners
    gc.collect()
    assert held_stream(device, _Owner(), new_stream=pool).cuda_stream in range(1, POOL_STREAMS + 1)


# ------------------------------------------------------------- feeder


def test_feeder_keeps_order_and_drains_once():
    feeder = DeviceFeeder(iter([{"i": k} for k in range(7)]), lambda b: dict(b, placed=True))
    out = list(feeder)
    assert [b["i"] for b in out] == list(range(7)) and all(b["placed"] for b in out)
    for _ in range(3):  # terminal: never blocks, never yields again
        with pytest.raises(StopIteration):
            next(feeder)


def test_feeder_places_the_next_batch_while_the_consumer_holds_one():
    placed = [threading.Event() for _ in range(4)]

    def place(batch):
        placed[batch["i"]].set()
        return batch

    feeder = DeviceFeeder(iter([{"i": k} for k in range(4)]), place, depth=2)
    try:
        assert next(feeder)["i"] == 0
        # Batch 0 is held (no further next()); the worker places 1 and 2.
        assert placed[1].wait(timeout=10) and placed[2].wait(timeout=10)
    finally:
        feeder.close()


def test_feeder_places_on_its_worker_thread():
    threads = []

    def place(batch):
        threads.append(threading.current_thread())
        return batch

    out = list(DeviceFeeder(iter([{"i": k} for k in range(5)]), place, name="unit-feeder"))
    assert [b["i"] for b in out] == list(range(5))
    assert len(threads) == 5 and all(t.name == "unit-feeder" for t in threads)
    assert threading.current_thread() not in threads


def test_feeder_depth_bounds_the_worker():
    """A consumer that holds back bounds the worker at depth queued + one
    placed batch waiting to enqueue: the source is not asked for more."""
    fetched = [0]
    placed = [threading.Event() for _ in range(6)]

    def source():
        for k in range(6):
            fetched[0] += 1
            yield {"i": k}

    def place(batch):
        placed[batch["i"]].set()
        return batch

    feeder = DeviceFeeder(source(), place, depth=2)
    try:
        assert placed[2].wait(timeout=10)  # 2 queued, the third waits to enqueue
        assert fetched[0] == 3 and not placed[3].is_set()
        assert next(feeder)["i"] == 0  # frees exactly one slot
        assert placed[3].wait(timeout=10)
        assert fetched[0] == 4 and not placed[4].is_set()
    finally:
        feeder.close()


def test_feeder_source_error_follows_the_good_batches():
    def source():
        yield {"i": 0}
        yield {"i": 1}
        raise RuntimeError("host pipeline exploded")

    feeder = DeviceFeeder(source(), lambda b: b, depth=2)
    assert [next(feeder)["i"], next(feeder)["i"]] == [0, 1]
    for _ in range(2):  # terminal and repeatable
        with pytest.raises(RuntimeError, match="exploded"):
            next(feeder)


def test_feeder_place_error_propagates():
    def place(batch):
        if batch["i"] == 1:
            raise ValueError("copy to the card failed")
        return batch

    feeder = DeviceFeeder(iter([{"i": k} for k in range(3)]), place, depth=2)
    assert next(feeder)["i"] == 0
    with pytest.raises(ValueError, match="copy to the card failed"):
        next(feeder)


def test_feeder_close_unblocks_a_worker_on_a_full_queue():
    placed = [threading.Event() for _ in range(50)]

    def place(batch):
        placed[batch["i"]].set()
        return batch

    feeder = DeviceFeeder(iter([{"i": k} for k in range(50)]), place, depth=1)
    assert placed[1].wait(timeout=10)  # one queued, one blocked on the put
    feeder.close()
    feeder._thread.join(timeout=10)
    assert not feeder._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(feeder)
    feeder.close()  # idempotent


def test_feeder_close_from_another_thread_unblocks_the_consumer():
    gate = threading.Event()

    def source():
        gate.wait(30)  # nothing arrives before close()
        yield {"i": 0}

    feeder = DeviceFeeder(source(), lambda b: b)
    result, waiting = {}, threading.Event()

    def consume():
        waiting.set()
        try:
            next(feeder)
        except BaseException as e:  # noqa: BLE001 — the test reads it
            result["error"] = e

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    assert waiting.wait(timeout=10)
    feeder.close()
    consumer.join(timeout=10)
    gate.set()
    assert not consumer.is_alive(), "consumer still blocked after close()"
    assert isinstance(result.get("error"), RuntimeError)


def test_feeder_context_manager_depth_and_stats():
    with pytest.raises(ValueError, match="depth"):
        DeviceFeeder(iter([]), lambda b: b, depth=0)
    with DeviceFeeder(iter([{"i": 0}]), lambda b: b, depth=3) as feeder:
        assert next(feeder)["i"] == 0
        with pytest.raises(StopIteration):
            next(feeder)
    assert not feeder._thread.is_alive()
    stats = feeder.stats()
    assert stats["batches"] == 1.0 and stats["depth"] == 3.0
    assert set(stats) >= {"fetch_s", "h2d_s", "wait_s", "depth_max", "depth_avg"}


# ------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def flax_params():
    return small_flax_params()


def test_engine_places_the_next_batch_while_one_executes(flax_params):
    """With the device loop holding batch 0 in ``execute_hook``, the
    feeder's worker has already placed batch 1: a serial loop would not
    touch it until batch 0 completed."""
    placed = [threading.Event() for _ in range(2)]
    executing, release = threading.Event(), threading.Event()
    def place_hook(formed):
        placed[1 if placed[0].is_set() else 0].set()

    def execute_hook(formed):
        if not executing.is_set():
            executing.set()
            assert release.wait(timeout=30)

    engine = ServeEngine(_config(buckets=[4], deadline_ms=60_000.0),
                         model=small_port_model(flax_params),
                         place_hook=place_hook, execute_hook=execute_hook)
    with engine:
        futures = [engine.submit(image) for image in _images(8)]
        assert executing.wait(timeout=30)
        assert placed[1].wait(timeout=30), "batch 1 was not placed while batch 0 executed"
        release.set()
        for future in futures:
            assert future.result(timeout=30).shape == (10,)
    stats = engine.stats()
    assert stats["ledger"]["batches"] == 2 and stats["feeder"]["batches"] == 2.0
    assert stats["replays"] == {"4": 0}  # the CPU runs eagerly


def test_drain_waits_for_admitted_requests(flax_params):
    release = threading.Event()
    engine = ServeEngine(_config(buckets=[2], deadline_ms=60_000.0),
                         model=small_port_model(flax_params),
                         execute_hook=lambda formed: release.wait(timeout=30))
    assert engine.drain(timeout_s=0.0)  # not started: nothing admitted
    with engine:
        futures = [engine.submit(image) for image in _images(4)]
        assert engine.drain(timeout_s=0.2, poll_s=0.01) is False
        assert not all(f.done() for f in futures)
        release.set()
        assert engine.drain(timeout_s=30, poll_s=0.01) is True
        assert all(f.done() for f in futures)
        assert engine._batcher.pending() == 0
    assert engine.stats()["ledger"]["requests"] == 4


def test_a_stopped_engine_is_collected(flax_params):
    """Stopped and dropped, an engine is collected: on the card that frees
    the streams it holds (utils.graphs.held_stream) for the next engine."""
    engine = ServeEngine(_config(buckets=[4], deadline_ms=50.0),
                         model=small_port_model(flax_params))
    with engine:
        futures = [engine.submit(image) for image in _images(5)]
        for future in futures:
            future.result(timeout=30)
    ref = weakref.ref(engine)
    del engine, futures, future
    gc.collect()
    assert ref() is None


def test_a_failed_execution_fails_its_batch_and_serving_goes_on(flax_params):
    calls = []

    def execute_hook(formed):
        calls.append(len(formed.requests))
        if len(calls) == 1:
            raise RuntimeError("the device failed this batch")

    engine = ServeEngine(_config(buckets=[1], deadline_ms=60_000.0),
                         model=small_port_model(flax_params), execute_hook=execute_hook)
    images = _images(2)
    with engine:
        with pytest.raises(RuntimeError, match="failed this batch"):
            engine.submit(images[0]).result(timeout=30)
        assert engine.submit(images[1]).result(timeout=30).shape == (10,)
    assert engine.stats()["errors"] == 1


def test_a_failed_placement_fails_its_batch_and_closes_admission(flax_params):
    def place_hook(formed):
        raise OSError("pinned memory exhausted")

    engine = ServeEngine(_config(buckets=[1], deadline_ms=60_000.0),
                         model=small_port_model(flax_params), place_hook=place_hook)
    image = _images(1)[0]
    with engine:
        with pytest.raises(OSError, match="pinned memory"):
            engine.submit(image).result(timeout=30)
        engine._device_thread.join(timeout=30)
        assert not engine._device_thread.is_alive()
        assert engine._batcher.closed
        with pytest.raises(ServeClosedError):
            engine._batcher.submit(image)
    assert engine.stats()["errors"] == 1


# ------------------------------------------------------- checkpoint path


def _trained(name, tmp_path):
    """A small model trained 2 steps on the CPU into a checkpoint in
    ``tmp_path``: a ViT with dropout, or a BoTNet with its running
    statistics. Returns (trained module, image size, overrides)."""
    if name == "vit_ti_patch16":
        size, overrides = 32, dict(SMALL, dropout_rate=0.1)
    else:
        size, overrides = 64, dict(stage_sizes=(1, 1, 1, 1))
    model = create_model(name, num_classes=10, image_size=size, seed=0, **overrides)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # a zero head (and zero bn3 scales) would train nothing
        torch.nn.init.normal_(model.head.weight, std=0.05, generator=gen)
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.zero_scale:
                torch.nn.init.uniform_(m.weight, 0.5, 1.5, generator=gen)
    config = TrainConfig(model_name=name, image_size=size, num_classes=10,
                         compute_dtype="float32", global_batch_size=8, num_train_images=64,
                         num_epochs=1, warmup_epochs=0, transpose_images=False, base_lr=0.01,
                         seed=0, checkpoint_dir=str(tmp_path))
    trainer = Trainer(config, model=model, device="cpu")
    feed = synth_resumable_iterator(seed=0, start_step=0, batch_size=8, image_size=size,
                                    num_classes=10)
    state, _ = trainer.fit(feed, num_steps=2, state=trainer.init_state())
    trainer.checkpointer.close()
    assert trainer.checkpointer.all_steps() == [2]
    return state.model, size, overrides


@pytest.mark.parametrize("name", ["vit_ti_patch16", "botnet_t3"])
def test_serving_a_checkpoint_equals_the_trained_module(name, tmp_path, monkeypatch):
    trained, size, overrides = _trained(name, tmp_path)
    if name == "botnet_t3":
        assert any(not torch.equal(m.running_var, torch.ones_like(m.running_var))
                   for m in trained.modules() if isinstance(m, BatchNorm))
    opened = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda f, *a, **k: opened.append(str(f))
                        or real_load(f, *a, **k))
    config = dict(model_name=name, image_size=size, model_overrides=overrides, buckets=[1, 4],
                  deadline_ms=60_000.0)
    served = ServeEngine(_config(checkpoint_dir=str(tmp_path), **config))
    assert served.startup_report["params_source"] == f"checkpoint:{tmp_path}"
    assert opened and all(os.path.basename(p) == PARAMS_FILE for p in opened)
    assert not any(OPT_STATE_FILE in p for p in opened)
    direct = ServeEngine(_config(**config), model=copy.deepcopy(trained))
    images = _images(8, seed=3, size=size)  # two full batches of 4
    out = {}
    for key, engine in (("served", served), ("direct", direct)):
        with engine:
            out[key] = np.stack([f.result(timeout=60)
                                 for f in [engine.submit(image) for image in images]])
    assert np.abs(out["direct"]).max() > 0.05
    np.testing.assert_array_equal(out["served"], out["direct"])


def test_serving_an_empty_checkpoint_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ServeEngine(_config(checkpoint_dir=str(tmp_path)))


def test_submit_raw_matches_sav_tpu_preprocess_and_infer(flax_params):
    """Raw decoded images of mixed sizes through the port's submit_raw
    against sav_tpu's preprocess_request followed by its build_infer_fn on
    the same flax parameters."""
    rng = np.random.default_rng(11)
    raws = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((300, 451, 3), (97, 131, 3), (64, 64, 3), (211, 120, 3), (33, 40, 3),
                          (500, 375, 3))]
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="fused", **SMALL)
    infer = jax.jit(jax_build_infer_fn(jax_model, jnp.float32))
    batch = np.stack([jax_preprocess.preprocess_request(raw, 32) for raw in raws])
    ref = np.asarray(infer(flax_params, {}, {"images": batch,
                                             "valid": np.ones(len(raws), np.float32)}))
    # One full batch of 6: a partial batch would wait out its deadline.
    with ServeEngine(_config(max_batch=6, deadline_ms=60_000.0), params=flax_params) as engine:
        out = np.stack([f.result(timeout=60) for f in [engine.submit_raw(r) for r in raws]])
        with pytest.raises(ValueError, match="decoded"):
            engine.submit_raw(np.zeros((40, 40), np.uint8))
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


# -------------------------------------------------------------- bench

BENCH_KEYS = {"metric", "unit", "outcome", "platform", "device", "card", "p50_latency_ms",
              "p95_latency_ms", "p99_latency_ms", "serve_throughput", "padding_waste_frac",
              "bucket_occupancy", "queue_depth_avg", "queue_depth_max", "deadline_overruns",
              "requests", "offered", "rejected_at_submit", "schedule_lag_ms", "summary",
              "startup", "replays", "feeder"}
BENCH_ARGS = ["--device", "cpu", "--model", "vit_ti_patch16", "--num-classes", "10",
              "--image-size", "32", "--model-overrides", json.dumps(TINY), "--max-batch", "4",
              "--deadline-ms", "30000"]


def test_bench_cli_prints_one_json_line():
    proc = subprocess.run([sys.executable, "-m", "sav_tpu_torch.serve.bench", *BENCH_ARGS,
                           "--requests", "24"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) >= BENCH_KEYS
    assert (out["outcome"], out["platform"], out["card"]) == ("ok", "cpu", None)
    assert out["requests"] == out["offered"] == 24 and out["rejected_at_submit"] == 0
    assert out["startup"]["buckets"] == [1, 2, 4]
    assert out["startup"]["bucket_hbm_source"] == "analytic"
    assert out["p50_latency_ms"] <= out["p99_latency_ms"]


@pytest.mark.parametrize("arm,extra", [("batch_1", ["--batch-1", "--requests", "8"]),
                                       ("open_loop", ["--rate", "400", "--requests", "20"])])
def test_bench_arms(arm, extra, capsys):
    assert bench.main([*BENCH_ARGS, *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if arm == "batch_1":
        assert out["startup"]["buckets"] == [1]
        assert set(out["bucket_occupancy"]) == {"1"} and out["requests"] == 8
    else:
        assert out["rate"] == 400.0 and "400.0 req/s" in out["metric"]
        assert out["offered"] == out["requests"] == 20 and out["rejected_at_submit"] == 0
