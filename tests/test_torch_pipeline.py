"""The port's host input pipeline (sav_tpu_torch.data.pipeline, image_ops,
autoaugment, mix) against sav_tpu's TF pipeline, on the CPU.

What is deterministic is held exactly: the bicubic resize (TF's
``ResizeBicubic``), the centre crop window, every image op and every
RandAugment/AutoAugment op at fixed magnitudes and signs, the host mixes
with their draws injected, and the eval and train preprocessing with the
window and flip injected, once TF decodes with the accurate integer DCT
that PIL uses, except at a crop's edge: TF's ``decode_and_crop_jpeg``
upsamples the chroma of the crop's first and last columns as at an image
edge, where the port decodes the whole image and crops it, so those
columns (and the EDGE output columns the resize reads them into) may
differ by more. TF's default decode uses the fast integer DCT; against it
the pixels differ by up to DECODE_TOL levels of 255 away from those edges
(on about 2/3 of them), and by MEAN_TOL on average over the whole image.
TF's draws (crop window, flip, the ops' choices, the mixes) and tf.data's
order cannot be reproduced, so the port's own draws are tested for their
laws instead, and ``load`` against sav_tpu's for its batch keys, shapes
and dtypes.
"""

import collections

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from sav_tpu.data import autoaugment as jax_aa  # noqa: E402
from sav_tpu.data import image_ops as jax_ops  # noqa: E402
from sav_tpu.data import mix as jax_mix  # noqa: E402
from sav_tpu.data import pipeline as jax_pipeline  # noqa: E402
from sav_tpu_torch.data import autoaugment, image_ops, mix, pipeline  # noqa: E402
from sav_tpu_torch.data.augment_spec import parse_augment_spec  # noqa: E402

# The largest difference, in levels of 255, between TF's default JPEG
# decode (INTEGER_FAST) and PIL's (the accurate integer DCT) measured on
# these images away from a crop's edge is 5 (on about 2/3 of the pixels);
# after the bicubic resize the same bound holds. A level of slack above it.
DECODE_TOL = 6
# The mean absolute difference over whole preprocessed images, crop edges
# included (measured: under 1.1).
MEAN_TOL = 1.5
# Output columns at each side of a resized crop that read its first or last
# input column (the bicubic taps reach two columns out).
EDGE = 2


def _image(h, w, seed=0):
    """A smooth-ish uint8 image: blocks of colour plus noise (JPEG-like)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    x = np.kron(base, np.ones((16, 16, 1)))[:h, :w] + rng.normal(0, 20, (h, w, 3))
    return np.clip(x, 0, 255).astype(np.uint8)


JPEGS = [pipeline.encode_jpeg(_image(h, w, seed), quality=90)
         for seed, (h, w) in enumerate([(300, 417), (451, 333), (240, 240)])]


@pytest.fixture
def accurate_tf_decode(monkeypatch):
    """sav_tpu's decodes with the accurate integer DCT (PIL's)."""
    decode_and_crop, decode = tf.image.decode_and_crop_jpeg, tf.io.decode_jpeg
    monkeypatch.setattr(tf.image, "decode_and_crop_jpeg", lambda *a, **k: decode_and_crop(
        *a, **k, dct_method="INTEGER_ACCURATE"))
    monkeypatch.setattr(tf.io, "decode_jpeg", lambda *a, **k: decode(
        *a, **k, dct_method="INTEGER_ACCURATE"))


def _diff(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def _mean_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


def _inner(x):
    """A resized crop without the EDGE columns at either side."""
    return np.asarray(x)[:, EDGE:-EDGE]


# ------------------------------------------------------------- preprocessing


@pytest.mark.parametrize("shape,size", [((300, 417), 224), ((97, 500), 64), ((150, 190), 224),
                                        ((224, 224), 224)])
def test_bicubic_resize_is_tfs(shape, size):
    image = _image(*shape, seed=5)
    want = jax_pipeline._resize_bicubic(tf.constant(image), size).numpy()
    np.testing.assert_array_equal(pipeline._resize_bicubic(image, size), want)
    f32 = tf.image.resize(tf.cast(image, tf.float32), [size, size], "bicubic").numpy()
    np.testing.assert_array_equal(pipeline.resize_bicubic_f32(image, size, size), f32)


def test_center_crop_window_is_sav_tpus():
    for h, w in [(300, 417), (451, 333), (100, 100), (57, 1000)]:
        want = jax_pipeline._center_crop_window(
            tf.image.encode_jpeg(np.zeros((h, w, 3), np.uint8)), 224).numpy()
        assert pipeline.center_crop_window((h, w), 224) == tuple(int(v) for v in want)


@pytest.mark.parametrize("mode", ["crop_resize", "resize_crop_0.875", "resize_crop_1.1"])
def test_eval_preprocess(mode, accurate_tf_decode):
    for jpeg in JPEGS:
        want = jax_pipeline._eval_preprocess(tf.constant(jpeg), 224, mode).numpy()
        got = pipeline._eval_preprocess(jpeg, 224, mode)
        if mode == "crop_resize":  # a crop decode: its edge columns
            got, want = _inner(got), _inner(want)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["crop_resize", "resize_crop_0.875"])
def test_eval_preprocess_within_the_decode_tolerance(mode):
    for jpeg in JPEGS:
        want = jax_pipeline._eval_preprocess(tf.constant(jpeg), 224, mode).numpy()
        got = pipeline._eval_preprocess(jpeg, 224, mode)
        assert _diff(_inner(got), _inner(want)) <= DECODE_TOL
        assert _mean_diff(got, want) <= MEAN_TOL


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("accurate", [True, False])
def test_train_preprocess_with_the_window_and_flip_injected(monkeypatch, request, flip,
                                                            accurate):
    if accurate:
        request.getfixturevalue("accurate_tf_decode")
    window = (37, 51, 201, 150)
    monkeypatch.setattr(jax_pipeline, "_distorted_bbox_crop_window",
                        lambda *a, **k: tf.constant(window, tf.int32))
    monkeypatch.setattr(tf.image, "random_flip_left_right",
                        tf.image.flip_left_right if flip else (lambda x: x))
    for jpeg in JPEGS:
        want = jax_pipeline._train_preprocess(tf.constant(jpeg), 160).numpy()
        got = pipeline._train_preprocess(jpeg, 160, window=window, flip=flip)
        if accurate:
            np.testing.assert_array_equal(_inner(got), _inner(want))
        else:
            assert _diff(_inner(got), _inner(want)) <= DECODE_TOL
        assert _mean_diff(got, want) <= MEAN_TOL


def test_decode_crop_against_tf(accurate_tf_decode):
    for jpeg in JPEGS:
        want = jax_pipeline._decode_crop(tf.constant(jpeg), [11, 23, 100, 120]).numpy()
        got = pipeline._decode_crop(jpeg, (11, 23, 100, 120))
        np.testing.assert_array_equal(got[:, 1:-1], want[:, 1:-1])
        full = tf.io.decode_jpeg(jpeg, channels=3).numpy()
        np.testing.assert_array_equal(pipeline._decode_crop(jpeg, (0, 0, *full.shape[:2])), full)
    assert pipeline.decoder_name().startswith("PIL ")


# ------------------------------------------------------------ image ops

IMAGE = _image(96, 80, seed=7)
FIXED_OPS = [
    ("blend", lambda m, a: m.blend(a, a[::-1], 1.7)),
    ("rotate", lambda m, a: m.rotate(a, np.float32(-13.5) if m is image_ops
                                     else tf.constant(-13.5, tf.float32))),
    ("shear_x", lambda m, a: m.shear_x(a, np.float32(0.27) if m is image_ops
                                       else tf.constant(0.27, tf.float32))),
    ("shear_y", lambda m, a: m.shear_y(a, -0.15)),
    ("translate_x", lambda m, a: m.translate_x(a, 45.0)),
    ("translate_y", lambda m, a: m.translate_y(a, -50.0)),
    ("invert", lambda m, a: m.invert(a)),
    ("posterize", lambda m, a: m.posterize(a, 2)),
    ("solarize", lambda m, a: m.solarize(a, 128)),
    ("solarize_256", lambda m, a: m.solarize(a, 256)),
    ("solarize_add", lambda m, a: m.solarize_add(a, 55)),
    ("color", lambda m, a: m.color(a, 1.45)),
    ("contrast", lambda m, a: m.contrast(a, 0.55)),
    ("brightness", lambda m, a: m.brightness(a, 1.45)),
    ("autocontrast", lambda m, a: m.autocontrast(a)),
    ("equalize", lambda m, a: m.equalize(a)),
    ("sharpness", lambda m, a: m.sharpness(a, 1.45)),
]


@pytest.mark.parametrize("name,op", FIXED_OPS, ids=[n for n, _ in FIXED_OPS])
def test_image_op_is_sav_tpus(name, op):
    image = IMAGE if name != "autocontrast" else (IMAGE // 2 + 40)
    want = np.asarray(op(jax_ops, tf.constant(image)))
    np.testing.assert_array_equal(op(image_ops, image), want)


def test_cutout_with_its_centre_injected(monkeypatch):
    centre = iter([tf.constant(90), tf.constant(3)])
    monkeypatch.setattr(tf.random, "uniform", lambda *a, **k: next(centre))
    want = jax_ops.cutout(tf.constant(IMAGE), 12).numpy()

    class Centre:
        draws = iter([90, 3])

        def integers(self, lo, hi):
            return next(self.draws)

    np.testing.assert_array_equal(image_ops.cutout(IMAGE, 12, Centre()), want)


class _Sign:
    """A generator stand-in whose every draw is ``value`` (the signs of
    signed magnitudes, cutout's centre)."""

    def __init__(self, value):
        self.value = value

    def integers(self, lo, hi):
        return self.value if self.value < hi else hi - 1


@pytest.mark.parametrize("name", autoaugment.RANDAUG_OPS)
@pytest.mark.parametrize("level,sign", [(5, 1), (9, 0), (10, 1)])
def test_augment_op_at_a_fixed_magnitude_is_sav_tpus(monkeypatch, name, level, sign):
    monkeypatch.setattr(jax_aa, "_signed",
                        lambda v: tf.cast(v, tf.float32) * float(sign * 2 - 1))
    monkeypatch.setattr(tf.random, "uniform", lambda *a, **k: tf.constant(sign, tf.int32))
    want = np.asarray(jax_aa._op_table(40, 100)[name](tf.constant(IMAGE), float(level)))
    got = autoaugment._op_table(40, 100)[name](IMAGE, float(level), _Sign(sign))
    np.testing.assert_array_equal(got, want)


def test_augment_policies_run_and_draw_from_the_generator():
    for spec in ("randaugment_405", "randaugment_15", "autoaugment", "none"):
        fn = autoaugment.augment_fn(parse_augment_spec(spec))
        a = fn(IMAGE, np.random.default_rng(3))
        b = fn(IMAGE, np.random.default_rng(3))
        assert a.dtype == np.uint8 and a.shape == IMAGE.shape
        np.testing.assert_array_equal(a, b)
    assert len(autoaugment.POLICY_V0) == 25


# -------------------------------------------------------------- the mixes


def _mix_batch(n=6):
    rng = np.random.default_rng(11)
    return {"images": rng.integers(0, 256, (n, 12, 10, 3)).astype(np.uint8),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def test_mixup_with_injected_draws(monkeypatch):
    batch = _mix_batch()
    ratio = np.float32([0.1, 0.9, 0.5, 0.33, 0.0, 1.0])
    monkeypatch.setattr(jax_mix, "_sample_beta", lambda shape, alpha: tf.constant(ratio))
    want = jax_mix.mixup({k: tf.constant(v) for k, v in batch.items()}, 0.2)
    got = mix.mixup(batch, 0.2, ratio=ratio)
    for key in ("images", "mix_labels", "ratio"):
        np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=key)


def _inject_boxes(monkeypatch, lam, cy, cx):
    draws = iter([tf.constant(lam), tf.constant(cy, tf.int32), tf.constant(cx, tf.int32)])
    monkeypatch.setattr(tf.random, "uniform", lambda *a, **k: next(draws))


def test_cutmix_with_injected_draws(monkeypatch):
    batch = _mix_batch()
    lam, cy, cx = (np.float32([0.3, 0.95, 0.0, 0.5, 0.7, 0.1]), np.array([0, 11, 5, 6, 2, 9]),
                   np.array([9, 0, 4, 5, 1, 3]))
    _inject_boxes(monkeypatch, lam, cy, cx)
    want = jax_mix.cutmix({k: tf.constant(v) for k, v in batch.items()})
    got = mix.cutmix(batch, lam=lam, cy=cy, cx=cx)
    for key in ("images", "mix_labels", "ratio"):
        np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=key)


def test_mixup_and_cutmix_with_injected_draws(monkeypatch):
    batch = _mix_batch(8)
    ratio = np.float32([0.2, 0.8, 0.6, 0.4])
    lam, cy, cx = np.float32([0.5, 0.2, 0.9, 0.0]), np.array([3, 7, 0, 11]), np.array([2, 8, 9, 0])
    monkeypatch.setattr(jax_mix, "_sample_beta", lambda shape, alpha: tf.constant(ratio))
    _inject_boxes(monkeypatch, lam, cy, cx)
    want = jax_mix.mixup_and_cutmix({k: tf.constant(v) for k, v in batch.items()})
    got = mix.apply_mixes(batch, parse_augment_spec("cutmix_mixup"),
                          draws={"ratio": ratio, "lam": lam, "cy": cy, "cx": cx})
    for key in ("images", "mix_labels", "ratio"):
        np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=key)
    plan = mix.mix_plan(8, 12, 10, parse_augment_spec("cutmix_mixup"),
                        draws={"ratio": ratio, "lam": lam, "cy": cy, "cx": cx})
    assert list(plan["partner"]) == [3, 0, 1, 2, 7, 4, 5, 6]
    assert list(plan["kind"]) == [mix.BLEND] * 4 + [mix.BOX] * 4


def test_host_mix_keys_are_the_device_mixes():
    """The host batch carries the keys the trainer reads from the device
    mixes: ``mix_labels`` (int) and ``ratio`` (float32) per example."""
    from sav_tpu_torch.ops import preprocess

    batch = _mix_batch(8)
    spec = parse_augment_spec("cutmix_mixup")
    host = mix.apply_mixes(batch, spec, rng=np.random.default_rng(0))
    _, mix_labels, ratio = preprocess.apply_mixes(
        torch.from_numpy(batch["images"]), torch.from_numpy(batch["labels"]), spec,
        generator=torch.Generator().manual_seed(0))
    assert host["mix_labels"].shape == tuple(mix_labels.shape)
    assert host["ratio"].dtype == np.float32 and host["ratio"].shape == tuple(ratio.shape)
    assert set(host) == {"images", "labels", "mix_labels", "ratio"}


# ------------------------------------------------------------------- load

SOURCE = (np.stack([_image(40, 48, seed=s) for s in range(12)]),
          np.arange(12, dtype=np.int64) % 5)


def _leaf(x):
    return (tuple(x.shape), "bfloat16" if "bfloat16" in str(x.dtype) else np.dtype(x.dtype).name)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bfloat16", [False, True])
@pytest.mark.parametrize("device_preprocess", [False, True])
@pytest.mark.parametrize("is_training", [True, False])
def test_load_batch_keys_shapes_and_dtypes(transpose, bfloat16, device_preprocess,
                                           is_training):
    # RandAugment changes no key, shape or dtype (and TF builds its graph
    # slowly): the mixes are what add keys.
    kwargs = dict(source=SOURCE, is_training=is_training, batch_dims=[4], image_size=32,
                  augment_name="cutmix_mixup", transpose=transpose,
                  bfloat16=bfloat16, device_preprocess=device_preprocess, seed=0,
                  process_index=0, process_count=1, epoch_mode=True,
                  split_examples=None)
    want = next(iter(jax_pipeline.load(jax_pipeline.Split.TRAIN, **kwargs)))
    got = next(iter(pipeline.load(pipeline.Split.TRAIN, num_workers=0, **kwargs)))
    assert {k: _leaf(v) for k, v in got.items()} == {k: _leaf(v) for k, v in want.items()}
    if bfloat16 and not device_preprocess:
        assert got["images"].dtype == torch.bfloat16


def test_load_nested_batch_dims():
    kwargs = dict(source=SOURCE, is_training=True, batch_dims=[2, 3], image_size=32,
                  augment_name="cutmix_mixup", transpose=True, seed=0, process_index=0,
                  process_count=1)
    want = next(iter(jax_pipeline.load(jax_pipeline.Split.TRAIN, **kwargs)))
    got = next(iter(pipeline.load(pipeline.Split.TRAIN, num_workers=0, **kwargs)))
    assert {k: _leaf(v) for k, v in got.items()} == {k: _leaf(v) for k, v in want.items()}


def test_load_eval_keeps_a_short_last_batch():
    batches = list(pipeline.load(pipeline.Split.TEST, source=SOURCE, is_training=False,
                                 batch_dims=[5], image_size=32, num_workers=0))
    assert [len(b["labels"]) for b in batches] == [5, 5, 2]
    np.testing.assert_array_equal(np.concatenate([b["labels"] for b in batches]), SOURCE[1])


def test_load_fake_data_and_errors(tmp_path):
    fake = next(pipeline.load(pipeline.Split.TRAIN, fake_data=True, is_training=True,
                              batch_dims=[3], image_size=8, transpose=True, bfloat16=True))
    assert tuple(fake["images"].shape) == (8, 8, 3, 3) and fake["images"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        next(pipeline.load(pipeline.Split.TRAIN, data_dir=str(tmp_path), is_training=True,
                           batch_dims=[2], num_workers=0))
    with pytest.raises(ValueError, match="device_preprocess"):
        next(pipeline.load(pipeline.Split.TRAIN, source=SOURCE, is_training=True,
                           batch_dims=[2], augment_name="cutmix_randaugment_405",
                           augment_before_mix=False, device_preprocess=True, num_workers=0))
    with pytest.raises(ValueError, match="smaller than the per-host batch"):
        next(pipeline.resumable_train_iterator(pipeline.Split.TRAIN, source=SOURCE,
                                               batch_dims=[13], image_size=32))


def test_host_shards_are_disjoint_and_sav_tpus():
    for hosts in (1, 3, 4):
        ranges = [pipeline._host_shard_range(pipeline.Split.VALID, i, hosts) for i in
                  range(hosts)]
        assert ranges == [jax_pipeline._host_shard_range(jax_pipeline.Split.VALID, i, hosts)
                          for i in range(hosts)]
        assert ranges[0][0] == 0 and ranges[-1][1] == 10_000
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# ------------------------------------------------------- the laws of the draws


def test_crop_window_laws():
    rng = np.random.default_rng(0)
    areas, fallbacks = [], 0
    for _ in range(2000):
        h, w = int(rng.integers(100, 600)), int(rng.integers(100, 600))
        y, x, ch, cw = pipeline.distorted_bbox_crop_window((h, w), rng)
        assert 0 <= y and y + ch <= h and 0 <= x and x + cw <= w
        if (y, x, ch, cw) == (0, 0, h, w):
            fallbacks += 1
            continue
        area = ch * cw / (h * w)
        assert 0.08 <= area <= 1.0 and area >= 0.1  # min_object_covered
        assert 3 / 4 - 0.02 <= cw / ch <= 4 / 3 + 0.02  # the pixel rounding of the sides
        areas.append(area)
    assert fallbacks < 100 and 0.3 < np.mean(areas) < 0.7
    # A window the ranges cannot fit falls back to the whole image.
    assert pipeline.distorted_bbox_crop_window((20, 600), rng, area_range=(0.9, 1.0)) == (
        0, 0, 20, 600)


def test_flip_law():
    image = pipeline.encode_jpeg(np.tile(np.arange(64, dtype=np.uint8)[None, :, None],
                                         (64, 1, 3)))
    flips = 0
    for i in range(400):
        out = pipeline._train_preprocess(image, 64, np.random.default_rng([1, i]),
                                         area_range=(1.0, 1.0))
        flips += out[32, 0, 0] > out[32, -1, 0]
    assert 160 < flips < 240  # p = 1/2: more than 4 standard deviations inside


def test_randaugment_draws_each_op_uniformly(monkeypatch):
    seen = collections.Counter()
    table = {name: (lambda name: lambda im, lv, rng: seen.update([name]) or im)(name)
             for name in autoaugment.RANDAUG_OPS}
    monkeypatch.setattr(autoaugment, "_op_table", lambda *a: table)
    rng = np.random.default_rng(0)
    for _ in range(4000):
        autoaugment.distort_image_with_randaugment(IMAGE, 2, 9, rng)
    total = sum(seen.values())
    assert 0.4 < total / 8000 < 0.6  # each layer applies with p ~ U[0.2, 0.8]
    assert set(seen) == set(autoaugment.RANDAUG_OPS)
    expected = total / len(autoaugment.RANDAUG_OPS)
    assert all(abs(n - expected) < 5 * expected ** 0.5 for n in seen.values())


# ------------------------------------------------------------------ resume


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                                        for k in a)


@pytest.mark.parametrize("augment", ["cutmix_mixup_randaugment_405", "autoaugment"])
def test_resumed_stream_is_the_uninterrupted_stream(augment):
    kwargs = dict(source=SOURCE, batch_dims=[4], image_size=32, augment_name=augment,
                  transpose=True, bfloat16=True, seed=5, num_workers=0)
    stream = pipeline.resumable_train_iterator(pipeline.Split.TRAIN, **kwargs)
    uninterrupted = [next(stream) for _ in range(7)]  # 3 batches an epoch: into epoch 2
    for start in (1, 3, 5):
        resumed = pipeline.resumable_train_iterator(pipeline.Split.TRAIN, start_step=start,
                                                    **kwargs)
        for want in uninterrupted[start:]:
            assert _equal(next(resumed), want)
    # Every example once an epoch.
    labels = [b["labels"] for b in uninterrupted[:3]]
    assert sorted(np.concatenate(labels)) == sorted(SOURCE[1])


def test_worker_processes_give_the_same_batches():
    kwargs = dict(source=SOURCE, batch_dims=[4], image_size=32,
                  augment_name="cutmix_mixup_randaugment_405", seed=2, epoch_mode=True,
                  is_training=True)
    inline = list(pipeline.load(pipeline.Split.TRAIN, num_workers=0, **kwargs))
    pooled = list(pipeline.load(pipeline.Split.TRAIN, num_workers=2, **kwargs))
    assert len(inline) == len(pooled) == 3
    assert all(_equal(a, b) for a, b in zip(inline, pooled))
