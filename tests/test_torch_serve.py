"""The port's serving stack (sav_tpu_torch.serve) on the CPU.

Engine tier: ``ServeEngine`` with ``device="cpu"`` on a small ViT whose
parameters come from the same flax tree as sav_tpu's ``build_infer_fn``;
results must match within 1e-4 (f32), padded rows must be exactly 0, and
admission, shutdown and the no-card refusal behave as in sav_tpu.

Unit tier: the port's own copies of the bucket ladder, latency ledger and
dynamic batcher, with the cases of tests/test_serve.py's unit tier.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.serve.engine import build_infer_fn as jax_build_infer_fn
from sav_tpu_torch.serve.batcher import (
    DeadlineInfeasibleError,
    DynamicBatcher,
    QueueFullError,
    ServeClosedError,
    ServeFuture,
)
from sav_tpu_torch.serve.bucketing import BucketLadder, default_ladder
from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine, build_infer_fn
from sav_tpu_torch.serve.latency import LatencyLedger, percentile
from test_torch_vit import SMALL, small_flax_params, small_port_model

torch.set_num_threads(2)

TOL = 1e-4


@pytest.fixture(scope="module")
def flax_params():
    return small_flax_params()


def _config(**kw):
    base = dict(
        model_name="vit_ti_patch16", num_classes=10, image_size=32,
        compute_dtype="float32", model_overrides=SMALL, device="cpu",
    )
    base.update(kw)
    return ServeConfig(**base)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _jax_logits(params, images, valid):
    model = jax_create_model(
        "vit_ti_patch16", num_classes=10, dtype=jnp.float32, backend="fused", **SMALL
    )
    infer = jax.jit(jax_build_infer_fn(model, jnp.float32))
    return np.asarray(infer(params, {}, {"images": images, "valid": valid}))


# ------------------------------------------------------------ engine tier


def test_engine_matches_sav_tpu_across_buckets(flax_params):
    images = _images(6)
    ref = _jax_logits(flax_params, images, np.ones(6, np.float32))
    engine = ServeEngine(_config(max_batch=4, deadline_ms=300.0), params=flax_params)
    assert engine.startup_report["params_source"] == "flax"
    assert set(engine.startup_report["warmup_step_s"]) == {"1", "2", "4"}
    with engine:
        out = [engine.submit(images[0]).result(timeout=30)]  # a batch of one
        futures = [engine.submit(images[i]) for i in range(1, 4)]  # pads to 4
        out += [f.result(timeout=30) for f in futures]
        futures = [engine.submit(images[i]) for i in range(4, 6)]
        out += [f.result(timeout=30) for f in futures]
    ledger = engine.stats()["ledger"]
    assert ledger["requests"] == 6
    assert len(ledger["bucket_occupancy"]) >= 2, ledger["bucket_occupancy"]
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(np.stack(out), ref, atol=TOL, rtol=TOL)


def test_bf16_engine_keeps_batch_norm_and_relative_tables_f32():
    """The engine casts the model to its compute dtype except what flax
    keeps f32 under a bf16 dtype: every BatchNorm's scale, bias and running
    statistics, and BoTMHSA's relative tables (the kernels' path reads them
    in f32). The statistics keep their bits."""
    from sav_tpu_torch.models.layers import BatchNorm, BoTMHSA
    from test_torch_botnet import IMAGE, small_flax_variables, small_port_model
    from test_torch_botnet import SMALL as BOTNET_SMALL

    variables = small_flax_variables(seed=5)
    want = {k: v.clone() for k, v in small_port_model(variables).state_dict().items()}
    config = _config(model_name="botnet_t3", model_overrides=BOTNET_SMALL, image_size=IMAGE,
                     compute_dtype="bfloat16", max_batch=2)
    engine = ServeEngine(config, params=variables)
    kept = {f"{name}.{t}" for name, m in engine.model.named_modules()
            if isinstance(m, (BatchNorm, BoTMHSA)) for t in type(m).F32_TENSORS}
    assert "stage4_block0.bn2.running_var" in kept and "stage4_block0.mhsa.rel_emb_h" in kept
    for name, value in engine.model.state_dict().items():
        if name in kept:
            assert value.dtype == torch.float32 and torch.equal(value, want[name]), name
        else:
            assert value.dtype == torch.bfloat16, name
    logits = engine._run(2, list(np.zeros((2, IMAGE, IMAGE, 3), np.uint8)))
    assert logits.dtype == np.float32 and np.isfinite(logits).all()


def test_padded_rows_are_exactly_zero(flax_params):
    images = _images(4, seed=1)
    valid = np.array([1, 1, 0, 0], np.float32)
    model = small_port_model(flax_params)
    out = build_infer_fn(model, torch.float32)(torch.from_numpy(images), torch.from_numpy(valid))
    assert out.dtype == torch.float32
    assert torch.count_nonzero(out[2:]) == 0
    assert torch.count_nonzero(out[:2]) == out[:2].numel()
    np.testing.assert_allclose(out.numpy(), _jax_logits(flax_params, images, valid), atol=TOL, rtol=TOL)


def test_float_images_are_refused(flax_params):
    infer = build_infer_fn(small_port_model(flax_params), torch.float32)
    with pytest.raises(ValueError, match="uint8"):
        infer(torch.zeros((1, 32, 32, 3)), torch.ones(1))
    with ServeEngine(_config(max_batch=1)) as engine:
        with pytest.raises(ValueError, match="uint8"):
            engine.submit(np.zeros((32, 32, 3), np.float32))
        with pytest.raises(ValueError, match="uint8"):
            engine.submit(np.zeros((16, 16, 3), np.uint8))


class _Gate:
    """Holds the feeder's worker inside the placement of each batch until
    ``release`` is set (admission/stop tests): the batcher's drain then
    stops pulling, so later requests stay queued."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def place_hook(self, formed):
        self.entered.set()
        if not self.release.wait(timeout=30):
            raise TimeoutError("gate never released")


def _gated_engine(flax_params, **kw):
    gate = _Gate()
    engine = ServeEngine(_config(buckets=[1], deadline_ms=60_000.0, **kw),
                         model=small_port_model(flax_params), place_hook=gate.place_hook)
    return engine.start(), gate


def test_queue_full_past_max_queue(flax_params):
    engine, gate = _gated_engine(flax_params, max_queue=2)
    image = _images(1)[0]
    try:
        first = engine.submit(image)
        assert gate.entered.wait(timeout=10)  # the feeder's worker holds it
        queued = [engine.submit(image) for _ in range(2)]
        with pytest.raises(QueueFullError, match="capacity"):
            engine.submit(image)
        assert engine.stats()["ledger"]["rejected"] == 1
        gate.release.set()
        for future in [first, *queued]:
            assert future.result(timeout=30).shape == (10,)
    finally:
        gate.release.set()
        engine.stop()


def test_stop_fails_queued_requests(flax_params):
    engine, gate = _gated_engine(flax_params, max_queue=4)
    image = _images(1)[0]
    first = engine.submit(image)
    assert gate.entered.wait(timeout=10)
    queued = [engine.submit(image) for _ in range(2)]
    stopper = threading.Thread(target=engine.stop, daemon=True)
    stopper.start()
    for future in queued:
        with pytest.raises(ServeClosedError):
            future.result(timeout=10)
    gate.release.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert first.result(timeout=10).shape == (10,)  # the in-flight batch finishes
    with pytest.raises(ServeClosedError):
        engine.submit(image)


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(ServeConfig(model_name="vit_ti_patch16"))
    config = _config()
    config.device = "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(config)


# -------------------------------------------------------------- unit tier


def test_bucket_ladder_lookups():
    ladder = BucketLadder([4, 1, 8, 2])
    assert ladder.buckets == (1, 2, 4, 8)
    assert ladder.max_batch == 8
    assert ladder.bucket_for(3) == 4
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        ladder.bucket_for(9)
    with pytest.raises(ValueError, match="at least one request"):
        ladder.bucket_for(0)
    with pytest.raises(ValueError, match="at least one rung"):
        BucketLadder([])


def test_default_ladder_is_pow2_and_reaches_max():
    assert default_ladder(32) == [1, 2, 4, 8, 16, 32]
    assert default_ladder(6) == [1, 2, 4, 6]
    assert default_ladder(1) == [1]
    with pytest.raises(ValueError):
        default_ladder(0)


def test_percentile_and_ledger_accounting():
    assert percentile([10.0, 20.0, 30.0, 40.0], 50.0) == 25.0
    with pytest.raises(ValueError):
        percentile([], 50.0)
    t = [0.0]
    ledger = LatencyLedger(clock=lambda: t[0])
    ledger.start()
    t[0] = 1.0
    ledger.observe_batch(
        bucket=4, latencies_s=[0.010, 0.020, 0.030],
        overruns_s=[-0.05, -0.04, 0.002], queue_depth=5, step_s=0.008,
    )
    t[0] = 2.0
    ledger.observe_batch(
        bucket=1, latencies_s=[0.040], overruns_s=[-0.1], queue_depth=0, step_s=0.004,
    )
    ledger.observe_rejected(2)
    s = ledger.summary()
    assert (s["requests"], s["batches"], s["rejected"]) == (4, 2, 2)
    assert s["padding_waste_frac"] == 0.2
    assert s["bucket_occupancy"]["4"] == {"batches": 1, "fill": 0.75}
    assert s["deadline_overruns"] == 1 and s["deadline_overrun_max_ms"] == 2.0
    assert s["latency_ms"]["p50"] == 25.0
    assert s["throughput_rps"] == 2.0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drain_in_thread(batcher):
    out = {}
    thread = threading.Thread(
        target=lambda: out.setdefault("formed", batcher.next_batch()), daemon=True
    )
    thread.start()
    return thread, out


def test_batcher_hot_queue_fills_largest_bucket():
    batcher = DynamicBatcher(
        BucketLadder([1, 2, 4]), step_time_fn=lambda b: 0.01, clock=FakeClock(),
    )
    for _ in range(6):
        batcher.submit("x")
    formed = batcher.next_batch()
    assert (formed.bucket, len(formed.requests), formed.queue_depth) == (4, 4, 2)
    batcher.close()


def test_batcher_waits_while_slack_remains_then_ships():
    clock = FakeClock()
    batcher = DynamicBatcher(
        BucketLadder([1, 2, 4]), step_time_fn=lambda b: 0.2,
        default_deadline_s=10.0, clock=clock,
    )
    batcher.submit("lonely")
    thread, out = _drain_in_thread(batcher)
    thread.join(timeout=0.4)
    assert thread.is_alive(), "shipped a partial batch with slack remaining"
    clock.t += 9.85  # past deadline - est_step
    thread.join(timeout=2.0)
    assert not thread.is_alive()
    assert (out["formed"].bucket, len(out["formed"].requests)) == (1, 1)
    batcher.close()


def test_batcher_sheds_and_rejects_at_admission():
    batcher = DynamicBatcher(
        BucketLadder([1, 2]), step_time_fn=lambda b: 0.1,
        default_deadline_s=0.25, clock=FakeClock(),
    )
    for tag in "abcd":
        batcher.submit(tag)
    with pytest.raises(DeadlineInfeasibleError, match="shedding"):
        batcher.submit("e")  # 3 batches ahead at 0.1 s > 0.25 s
    batcher.close()
    bounded = DynamicBatcher(BucketLadder([1, 2]), step_time_fn=lambda b: 0.0, max_queue=2)
    bounded.submit("a")
    bounded.submit("b")
    with pytest.raises(QueueFullError, match="capacity"):
        bounded.submit("c")
    assert bounded.stats()["rejected"] == 1
    bounded.close()


def test_batcher_close_and_future_semantics():
    batcher = DynamicBatcher(BucketLadder([4]), step_time_fn=lambda b: 0.0)
    future = batcher.submit("a")
    batcher.close()
    with pytest.raises(ServeClosedError):
        future.result(timeout=1.0)
    with pytest.raises(ServeClosedError):
        batcher.submit("b")
    assert batcher.next_batch() is None
    pending = ServeFuture()
    with pytest.raises(TimeoutError):
        pending.result(timeout=0.05)
    pending.set_result(41)
    assert pending.result(timeout=0.1) == 41
