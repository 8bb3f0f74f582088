"""The port's prediction-quality primitives against sav_tpu's, on the CPU.

- ``output_digests`` against ``sav_tpu.serve.quality.output_digests`` on
  the same numpy logits, f32 and bf16, with ties, all-equal rows, a
  single-class head and padded rows: ``top1`` and ``margin`` exact,
  ``entropy`` within 1e-6 (relative: at DeiT's 1,000 classes the two
  libraries' f32 sums differ by up to ~5e-7 of ~6.9 nats). (sav_tpu's engine feeds its digests f32 logits;
  the port takes the entropy from ``log_softmax`` in f32 whatever the
  logits' dtype, so on bf16 logits it is held against sav_tpu's on the
  same values in f32.)
- The probe batch's bytes and ``probe_id``, ``fingerprint_logits`` and
  the reference file (first writer wins) equal sav_tpu's.
- ``QualityTracker``, ``ProbeLedger`` and ``AgreementScorer`` snapshots
  equal sav_tpu's on the same seeded streams, snapshot by snapshot, and
  the quality alert rules fire exactly one episode on the cumulative
  counters, as sav_tpu's do.
- ``noise_params`` equals sav_tpu's noised tree carried across by
  ``params_from_flax``, exactly.

Every comparison is exact equality unless a test says otherwise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.obs import alerts as jax_alerts
from sav_tpu.obs import quality as jax_quality
from sav_tpu.serve import quality as jax_serve_quality
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.obs import alerts
from sav_tpu_torch.obs import quality
from sav_tpu_torch.serve import quality as serve_quality
from test_torch_vit import small_flax_params, small_port_model

ENTROPY_TOL = 1e-6


def _logits(num_classes: int, seed: int) -> np.ndarray:
    """Eight rows of seeded logits with the awkward rows planted: row 1 all
    equal, row 2 two equal maxima (first at a later slot than 0), row 3 the
    maximum at the last class, row 4 a maximum equal to the dtype's lowest
    runner-up candidate's neighbour (a large negative row)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (8, num_classes)).astype(np.float32)
    x[1] = 0.75
    if num_classes > 2:
        x[2] = rng.normal(0.0, 1.0, num_classes).astype(np.float32)
        x[2, 1] = x[2, num_classes - 1] = np.float32(5.0)
    x[3, -1] = x[3].max() + 1.0
    x[4] = -1e4 + x[4]
    return x


VALID = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


@pytest.mark.parametrize("num_classes", [1, 2, 10, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_digests_match_sav_tpu(num_classes, dtype):
    logits = _logits(num_classes, seed=num_classes)
    port_logits = torch.from_numpy(logits).to(getattr(torch, dtype))
    jax_logits = jnp.asarray(logits).astype(getattr(jnp, dtype))
    # The same values on both sides (f32 -> bf16 rounds to nearest even).
    np.testing.assert_array_equal(port_logits.float().numpy(),
                                  np.asarray(jax_logits.astype(jnp.float32)))
    got = serve_quality.output_digests(port_logits, torch.from_numpy(VALID))
    want = jax_serve_quality.output_digests(jax_logits, jnp.asarray(VALID))
    assert got["top1"].dtype == torch.int32
    assert got["margin"].dtype == got["entropy"].dtype == torch.float32
    np.testing.assert_array_equal(got["top1"].numpy(), np.asarray(want["top1"]))
    np.testing.assert_array_equal(got["margin"].numpy(), np.asarray(want["margin"]))
    # The entropy in f32 on both sides (see the module docstring).
    want_entropy = jax_serve_quality.output_digests(
        jax_logits.astype(jnp.float32), jnp.asarray(VALID))["entropy"]
    np.testing.assert_allclose(got["entropy"].numpy(), np.asarray(want_entropy),
                               rtol=ENTROPY_TOL, atol=ENTROPY_TOL)
    # The planted rows: padded rows 0, an all-equal row's margin 0 (never
    # -inf), its top-1 the first slot, a tie's top-1 the first maximum.
    assert (got["top1"][6:] == 0).all() and (got["margin"][6:] == 0).all()
    assert (got["entropy"][6:] == 0).all()
    assert got["margin"][1] == 0 and got["top1"][1] == 0
    if num_classes > 2:
        assert got["top1"][2] == 1 and got["margin"][2] == 0
    if num_classes == 1:
        assert (got["margin"] == 0).all() and (got["entropy"] == 0).all()


def test_digested_infer_fn_returns_the_logits_and_their_digests():
    valid = torch.tensor([1.0, 1.0, 0.0])
    logits = torch.from_numpy(_logits(10, seed=3)[:3]) * valid[:, None]
    infer = serve_quality.digested_infer_fn(lambda images, v: logits)
    out = infer(torch.zeros(3, 32, 32, 3, dtype=torch.uint8), valid)
    assert set(out) == {"logits", "top1", "margin", "entropy"}
    assert out["logits"] is logits
    for key, value in serve_quality.output_digests(logits, valid).items():
        assert torch.equal(out[key], value), key


@pytest.mark.parametrize("image_size,rows", [(32, 4), (48, 4), (32, 2), (224, 4)])
def test_probe_batch_bytes_and_id_match_sav_tpu(image_size, rows):
    images, probe_id = serve_quality.make_probe_batch(image_size, rows)
    want_images, want_id = jax_serve_quality.make_probe_batch(image_size, rows)
    assert images.shape == (rows, image_size, image_size, 3) and images.dtype == np.uint8
    assert images.tobytes() == want_images.tobytes() and probe_id == want_id


def test_fingerprint_and_reference_file_match_sav_tpu(tmp_path):
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(10).astype(np.float32) for _ in range(4)]
    assert (serve_quality.fingerprint_logits(rows)
            == jax_serve_quality.fingerprint_logits(rows))
    bumped = [r.copy() for r in rows]
    bumped[2][3] = np.nextafter(bumped[2][3], np.float32(np.inf))
    assert serve_quality.fingerprint_logits(bumped) != serve_quality.fingerprint_logits(rows)
    assert (serve_quality.fingerprint_logits(bumped)
            == jax_serve_quality.fingerprint_logits(bumped))
    for mod, name in ((serve_quality, "port"), (jax_serve_quality, "jax")):
        d = str(tmp_path / name)
        assert mod.load_reference(d) == {}
        mod.store_reference(d, "p1:bfloat16", "aaaa")
        mod.store_reference(d, "p1:bfloat16", "bbbb")  # first writer wins
        mod.store_reference(d, "p1:int8", "cccc")      # per-dtype keys coexist
        mod.store_reference(None, "k", "v")
        assert mod.load_reference(None) == {}
    with open(tmp_path / "port" / "fleet" / "probe_reference.json") as f:
        port_doc = f.read()
    with open(tmp_path / "jax" / "fleet" / "probe_reference.json") as f:
        assert f.read() == port_doc
    assert json.loads(port_doc) == {"p1:bfloat16": "aaaa", "p1:int8": "cccc"}
    # Each side reads the other's file.
    assert serve_quality.load_reference(str(tmp_path / "jax")) == json.loads(port_doc)


# ------------------------------------------------------------- the folds


def _digest_stream(seed: int, batches: int):
    """Seeded batches of (top1, margin, entropy): a stable regime, then a
    drifted one (a collapsed class mix and entropy) from the middle on."""
    rng = np.random.default_rng(seed)
    for i in range(batches):
        n = int(rng.integers(1, 33))
        drifted = i >= batches // 2
        top1 = (np.full(n, 3) if drifted else rng.integers(0, 10, n)).tolist()
        margin = np.round(rng.uniform(0, 5, n), 4).tolist()
        centre = 0.2 if drifted else 2.2
        entropy = np.round(centre + 0.05 * rng.standard_normal(n), 5).tolist()
        yield top1, margin, entropy


@pytest.mark.parametrize("window,reference_min", [(512, 256), (64, 40), (100, 10)])
def test_quality_tracker_snapshots_match_sav_tpu(window, reference_min):
    port = quality.QualityTracker(window=window, reference_min=reference_min)
    jax_side = jax_quality.QualityTracker(window=window, reference_min=reference_min)
    assert port.snapshot() == jax_side.snapshot() == {"n": 0}
    snaps = 0
    for top1, margin, entropy in _digest_stream(seed=window, batches=40):
        port.observe_digests(top1, margin, entropy, num_classes=10)
        jax_side.observe_digests(top1, margin, entropy, num_classes=10)
        assert port.snapshot() == jax_side.snapshot()
        snaps += 1
    final = port.snapshot()
    assert snaps == 40 and final["ref_n"] == reference_min and final["churn"] > 0.5


def test_probe_ledger_snapshots_match_sav_tpu():
    rng = np.random.default_rng(1)
    port, jax_side = quality.ProbeLedger(), jax_quality.ProbeLedger()
    assert port.snapshot() == jax_side.snapshot()
    assert "probe_ok_frac" not in port.snapshot()  # skip, never zero-fill
    for _ in range(50):
        event = rng.integers(0, 3)
        if event == 2:
            port.record_shed()
            jax_side.record_shed()
        else:
            fingerprint = "aa" if event == 0 else f"b{rng.integers(0, 9)}"
            kw = dict(fingerprint=fingerprint, expected="aa", probe_id="p1")
            assert port.record(**kw) == jax_side.record(**kw)
        assert port.snapshot() == jax_side.snapshot()
    snap = port.snapshot()
    assert snap["probe_mismatch"] > 0 and snap["probe_shed"] > 0


def test_agreement_scorer_snapshots_match_sav_tpu():
    rng = np.random.default_rng(2)
    port, jax_side = quality.AgreementScorer(window=32), jax_quality.AgreementScorer(window=32)
    pairs = [("bfloat16", "bfloat16"), ("bfloat16", "int8"), ("int8", "int8"),
             ("float32", "bfloat16"), (None, "int8")]
    for i in range(120):
        primary, shadow = pairs[int(rng.integers(0, len(pairs)))]
        if rng.uniform() < 0.1:
            port.record_shed()
            jax_side.record_shed()
            continue
        logits = rng.normal(0, 3, 6).round(3).tolist()
        drift = (np.array(logits) * (1 + rng.uniform(-0.12, 0.12, 6))).round(3).tolist()
        with_logits = rng.uniform() < 0.8
        top1 = int(np.argmax(logits))
        other = top1 if rng.uniform() < 0.9 else (top1 + 1) % 6
        kw = dict(primary_logits=logits if with_logits else None,
                  shadow_logits=drift if with_logits else None)
        assert (port.score_shadow(primary, shadow, top1, other, **kw)
                == jax_side.score_shadow(primary, shadow, top1, other, **kw))
        assert port.snapshot() == jax_side.snapshot(), i
    for a, b in pairs:
        assert quality.pair_key(a, b) == jax_quality.pair_key(a, b)
        assert quality.envelope_rel(a, b) == jax_quality.envelope_rel(a, b)
    snap = port.snapshot()
    assert snap["breach"] > 0 and snap["shed"] > 0 and len(snap["pairs"]) == len(pairs)


def test_quality_rules_fire_one_episode_on_the_monotonic_counters(tmp_path):
    """A probe mismatch and a shadow breach each increment a cumulative
    counter; each for_s=0 rule fires once, stays quiet while its counter
    holds or grows, and resolves once at finalize — alerts.jsonl byte for
    byte sav_tpu's on the same beats."""
    ledger, scorer = quality.ProbeLedger(), quality.AgreementScorer()
    beats = []
    for i in range(12):
        if i in (3, 7):
            ledger.record(fingerprint="bad", expected="good", probe_id="p")
        else:
            ledger.record(fingerprint="good", expected="good", probe_id="p")
        scorer.score_shadow("bfloat16", "bfloat16", 1, 1 if i not in (5, 6, 9) else 2)
        beats.append({"quality": ledger.snapshot(), "shadow": scorer.snapshot()})
    lines = {}
    for mod, name in ((alerts, "port"), (jax_alerts, "jax")):
        d = str(tmp_path / name)
        engine = mod.AlertEngine(mod.quality_rules(), log_dir=d, proc="router")
        for i, beat in enumerate(beats):
            engine.observe(beat, now=100.0 + i)
        engine.finalize(200.0)
        with open(os.path.join(d, "fleet", "alerts.jsonl")) as f:
            lines[name] = f.read()
    assert lines["port"] == lines["jax"]
    episodes = alerts.episodes(alerts.read_alerts(str(tmp_path / "port")))
    for rule in ("quality-probe-mismatch", "shadow-agreement"):
        assert episodes[rule]["fired"] == 1 and episodes[rule]["resolved"] == 1
        assert episodes[rule]["active"] is False
    assert set(episodes) == {"quality-probe-mismatch", "shadow-agreement"}


@pytest.mark.parametrize("scale,seed", [(0.5, 0), (0.05, 3)])
def test_noise_params_match_sav_tpu_carried_across(scale, seed):
    """The port's noised parameters equal sav_tpu's noised flax tree carried
    across by params_from_flax, bit for bit; the draws follow the flax tree's
    flattening order, so every leaf is drawn from the same stream."""
    params = small_flax_params()
    want = params_from_flax(jax_serve_quality.noise_params(params, scale, seed=seed))
    model = small_port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    serve_quality.noise_params(model, scale, seed=seed)
    got = model.state_dict()
    assert set(want) <= set(got)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
        assert not torch.equal(got[name], before[name]), name
    # Buffers are not parameters: left alone.
    for name in set(got) - set(want):
        assert torch.equal(got[name], before[name]), name
