"""The port's device preprocessing (sav_tpu_torch.ops.preprocess mixes and
sav_tpu_torch.data.augment_spec) against sav_tpu's, on the CPU.

Draws from ``jax.random`` cannot be matched by a ``torch.Generator``, so the
mixes are compared with the very values ``jax.random`` drew injected on the
port's side (the keys split as ``sav_tpu.ops.preprocess`` splits them).
Tolerances: images 1e-6 relative on 0..255 (the same f32 operations in the
same order; a fused multiply-add on either side moves the last bit), mix
labels and ratios exactly (the kept area is a count of pixels times the
f32 reciprocal of the image's, as XLA forms ``jnp.mean``). The port's own samplers are checked for their distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.data import augment_spec as jax_spec
from sav_tpu.ops import preprocess as jax_pp
from sav_tpu_torch.data import augment_spec
from sav_tpu_torch.ops import preprocess as pp

torch.set_num_threads(2)

IMAGE_RTOL = 1e-6


def _batch(n, h=12, w=10, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    labels = rng.integers(0, 1000, (n,)).astype(np.int32)
    return images, labels


def _cutmix_draws(key, n, h, w):
    """The lam, cy, cx that sav_tpu's ``_cutmix_mask`` draws from ``key``."""
    k_lam, k_cy, k_cx = jax.random.split(key, 3)
    return {"lam": torch.from_numpy(np.array(jax.random.uniform(k_lam, (n,)))),
            "cy": torch.from_numpy(np.array(jax.random.randint(k_cy, (n,), 0, h))),
            "cx": torch.from_numpy(np.array(jax.random.randint(k_cx, (n,), 0, w)))}


def _mixup_ratio(key, n, alpha):
    return torch.from_numpy(np.array(jax.random.beta(key, alpha, alpha, (n,))))


def _check(got, want):
    x, labels, ratio = got
    wx, wlabels, wratio = (np.asarray(a) for a in want)
    np.testing.assert_allclose(x.numpy(), wx, rtol=IMAGE_RTOL, atol=1e-6)
    np.testing.assert_array_equal(labels.numpy(), wlabels)
    np.testing.assert_array_equal(ratio.numpy(), wratio)


@pytest.mark.parametrize("alpha,seed", [(0.2, 0), (0.4, 1), (1.0, 2)])
def test_mixup_matches_sav_tpu_under_its_draws(alpha, seed):
    images, labels = _batch(8, seed=seed)
    key = jax.random.PRNGKey(seed)
    want = jax_pp.mixup(key, jnp.asarray(images), jnp.asarray(labels), alpha)
    got = pp.mixup(torch.from_numpy(images), torch.from_numpy(labels), alpha,
                   ratio=_mixup_ratio(key, 8, alpha))
    _check(got, want)


@pytest.mark.parametrize("n,h,w,seed", [(8, 12, 10, 0), (5, 7, 7, 3), (16, 32, 32, 4)])
def test_cutmix_matches_sav_tpu_under_its_draws(n, h, w, seed):
    images, labels = _batch(n, h, w, seed=seed)
    key = jax.random.PRNGKey(seed)
    want = jax_pp.cutmix(key, jnp.asarray(images), jnp.asarray(labels))
    got = pp.cutmix(torch.from_numpy(images), torch.from_numpy(labels),
                    **_cutmix_draws(key, n, h, w))
    _check(got, want)
    keep, ratio = pp._cutmix_mask(n, h, w, **_cutmix_draws(key, n, h, w))
    want_keep, want_ratio = jax_pp._cutmix_mask(key, n, h, w)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(ratio.numpy(), np.asarray(want_ratio))


@pytest.mark.parametrize("spec_name", [
    "cutmix_mixup_randaugment_405", "mixup_0.4", "cutmix", "randaugment_405", "none",
])
def test_apply_mixes_matches_sav_tpu_under_its_draws(spec_name):
    n, h, w = 10, 12, 10
    images, labels = _batch(n, h, w, seed=5)
    key = jax.random.PRNGKey(5)
    spec, jspec = augment_spec.parse_augment_spec(spec_name), jax_spec.parse_augment_spec(spec_name)
    want = jax_pp.apply_mixes(key, jnp.asarray(images), jnp.asarray(labels), jspec)
    if spec.cutmix and spec.mixup:
        k_mu, k_cm = jax.random.split(key)
        draws = {"ratio": _mixup_ratio(k_mu, n // 2, spec.mixup_alpha),
                 **_cutmix_draws(k_cm, n - n // 2, h, w)}
    elif spec.mixup:
        draws = {"ratio": _mixup_ratio(key, n, spec.mixup_alpha)}
    elif spec.cutmix:
        draws = _cutmix_draws(key, n, h, w)
    else:
        draws = {}
    got = pp.apply_mixes(torch.from_numpy(images), torch.from_numpy(labels), spec, draws=draws)
    if not spec.mixes:
        assert got[1] is None and got[2] is None and want[1] is None
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        return
    _check(got, want)


@pytest.mark.parametrize("name", [
    None, "", "none", "cutmix_mixup_randaugment_405", "cutmix_mixup_randaugment_210",
    "mixup_0.4_randaugment_9", "cutmix", "mixup", "autoaugment", "autoaugment_randaugment_5",
    "randaugment_100", "mixup_1.5_cutmix",
])
def test_parse_augment_spec_matches_sav_tpu(name):
    got, want = augment_spec.parse_augment_spec(name), jax_spec.parse_augment_spec(name)
    assert dataclasses_dict(got) == dataclasses_dict(want)
    assert got.mixes == want.mixes


def dataclasses_dict(spec):
    import dataclasses

    return dataclasses.asdict(spec)


def test_beta_sampler_has_the_beta_moments():
    """Beta(a, a) has mean 1/2 and variance 1 / (4 (2a + 1)); over 10⁵
    draws the standard error of the mean is about 1.2e-3 at a = 0.2 and of
    the variance about 6e-4, so 5e-3 is four or more standard errors."""
    generator = torch.Generator().manual_seed(0)
    for alpha in (0.2, 1.0, 2.0):
        draws = pp.sample_beta(alpha, 100_000, generator=generator, device=torch.device("cpu"))
        assert draws.dtype == torch.float32 and torch.isfinite(draws).all()
        assert float(draws.min()) >= 0.0 and float(draws.max()) <= 1.0
        assert abs(float(draws.mean()) - 0.5) < 5e-3
        assert abs(float(draws.var()) - 1.0 / (4.0 * (2.0 * alpha + 1.0))) < 5e-3


def test_mixes_draw_from_the_generator_they_are_given():
    images, labels = _batch(8)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    spec = augment_spec.parse_augment_spec("cutmix_mixup")
    a = pp.apply_mixes(x, y, spec, generator=torch.Generator().manual_seed(3))
    b = pp.apply_mixes(x, y, spec, generator=torch.Generator().manual_seed(3))
    c = pp.apply_mixes(x, y, spec, generator=torch.Generator().manual_seed(4))
    default = torch.get_rng_state()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0])
    assert torch.equal(default, torch.get_rng_state())


def test_cutmix_box_geometry():
    """The pasted box is ``centre ± (side // 2)`` rows and columns, side the
    int32 truncation of ``sqrt(1 - lam)`` times the image's, clipped to the
    image; the ratio is the kept share of the pixels."""
    h, w = 20, 16
    lam = torch.tensor([0.0, 0.75, 0.99, 0.5, 0.36])
    cy = torch.tensor([10, 0, 19, 3, 19])
    cx = torch.tensor([8, 15, 0, 2, 15])
    keep, ratio = pp._cutmix_mask(5, h, w, lam=lam, cy=cy, cx=cx)
    assert keep.shape == (5, h, w, 1)
    for i in range(5):
        side = float(np.sqrt(np.float32(1.0) - np.float32(lam[i])))
        half_h, half_w = int(np.float32(side) * h) // 2, int(np.float32(side) * w) // 2
        y0, y1 = max(int(cy[i]) - half_h, 0), min(int(cy[i]) + half_h, h)
        x0, x1 = max(int(cx[i]) - half_w, 0), min(int(cx[i]) + half_w, w)
        want = np.ones((h, w), np.float32)
        want[y0:y1, x0:x1] = 0.0
        np.testing.assert_array_equal(keep[i, :, :, 0].numpy(), want)
        assert float(ratio[i]) == float(np.float32(want.sum()) * np.float32(1.0 / (h * w)))
    # lam 0: the full-size box centred mid-image cuts exactly its middle.
    assert float(ratio[0]) == 0.0
