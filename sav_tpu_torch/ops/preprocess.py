"""Device-side batch preprocessing: normalisation, MixUp and CutMix (port
of ``sav_tpu/ops/preprocess.py``).

The trainer's ``device_preprocess`` ships post-augment uint8 images (half
the bytes of a bf16 batch) and finishes them inside the train step: the
augment string's mixes on the 0..255 values, then the per-channel
normalisation in f32. The mixes mirror ``sav_tpu``'s op for op: MixUp
draws one Beta(alpha, alpha) ratio per example against the roll-by-1
partner, CutMix pastes one box per example from the partner with the
kept area as the label ratio, and the combined policy runs MixUp on the
first half of the batch and CutMix on the second.

The draws come from the ``torch.Generator`` the caller passes, on the
images' device, in a fixed order (the Beta ratios; then lam, the box
centres' rows and columns). ``jax.random``'s numbers cannot be matched, so
each function also takes its draws injected (``ratio``; ``lam``, ``cy``,
``cx``), which the tests use to hold the arithmetic against ``sav_tpu``'s.
Nothing here copies from the host: the functions run inside a captured
CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB


@functools.cache
def _statistics(device: torch.device) -> tuple:
    """MEAN_RGB and STDDEV_RGB as f32 tensors on ``device``, made once per
    device: a program captured as a CUDA graph must not copy them from the
    host on every call (a capture cannot hold such a copy)."""
    return (torch.tensor(MEAN_RGB, dtype=torch.float32, device=device),
            torch.tensor(STDDEV_RGB, dtype=torch.float32, device=device))


def normalize_images(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(x - MEAN_RGB) / STDDEV_RGB`` on 0..255 NHWC input, cast to ``dtype``.

    The arithmetic runs in f32 before the cast, so uint8 and pre-floated
    inputs give identical values (as in ``sav_tpu``).
    """
    x = images.to(torch.float32)
    mean, std = _statistics(x.device)
    return ((x - mean) / std).to(dtype)


def sample_beta(alpha: float, n: int, *, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``n`` draws of Beta(alpha, alpha) as G₁ / (G₁ + G₂) of two
    Gamma(alpha) draws from ``generator`` (``torch.distributions.Beta``
    takes no generator). Where both gammas underflow to 0, which a small
    alpha allows, the ratio is the distribution's mean, 0.5."""
    gammas = torch._standard_gamma(
        torch.full((2, n), alpha, dtype=torch.float32, device=device), generator=generator)
    return torch.nan_to_num(gammas[0] / (gammas[0] + gammas[1]), nan=0.5)


def mixup(images: torch.Tensor, labels: torch.Tensor, alpha: float = 0.2, *,
          generator: Optional[torch.Generator] = None,
          ratio: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``r·x + (1 - r)·roll(x)``, r ~ Beta(alpha, alpha) per example (or
    the given ``ratio``). Returns ``(mixed, mix_labels, ratio)``; images
    are 0..255 f32."""
    x = images.to(torch.float32)
    if ratio is None:
        ratio = sample_beta(alpha, x.shape[0], generator=generator, device=x.device)
    r = ratio[:, None, None, None]
    mixed = r * x + (1.0 - r) * torch.roll(x, 1, 0)
    return mixed, torch.roll(labels, 1, 0), ratio


def _cutmix_mask(n: int, height: int, width: int, *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None,
                 lam: Optional[torch.Tensor] = None, cy: Optional[torch.Tensor] = None,
                 cx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example keep mask ``[n, h, w, 1]`` and kept-area ratio ``[n]``.

    The box side is ``sqrt(1 - lam)`` of the image's, lam ~ U(0, 1) =
    Beta(1, 1), truncated to int32 pixels; its centre (cy, cx) is uniform
    over the pixels; the box spans ``centre ± side // 2``, clipped to the
    image. ``sav_tpu``'s geometry exactly; the ratio is the mask's mean.
    """
    if lam is None:
        lam = torch.rand((n,), generator=generator, device=device)
    if cy is None:
        cy = torch.randint(0, height, (n,), generator=generator, device=device)
    if cx is None:
        cx = torch.randint(0, width, (n,), generator=generator, device=device)
    cut = torch.sqrt(1.0 - lam)
    cut_h = (cut * height).to(torch.int32)
    cut_w = (cut * width).to(torch.int32)
    cy, cx = cy.to(torch.int32), cx.to(torch.int32)
    y0 = torch.clamp(cy - cut_h // 2, 0, height)[:, None, None, None]
    y1 = torch.clamp(cy + cut_h // 2, 0, height)[:, None, None, None]
    x0 = torch.clamp(cx - cut_w // 2, 0, width)[:, None, None, None]
    x1 = torch.clamp(cx + cut_w // 2, 0, width)[:, None, None, None]
    rows = torch.arange(height, dtype=torch.int32, device=lam.device)[None, :, None, None]
    cols = torch.arange(width, dtype=torch.int32, device=lam.device)[None, None, :, None]
    inside = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    keep = 1.0 - inside.to(torch.float32)
    # The mean as XLA forms jnp.mean's: the (exact) pixel count times the
    # f32 reciprocal of h·w.
    return keep, keep.sum(dim=(1, 2, 3)) * (1.0 / (height * width))


def cutmix(images: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0, *,
           generator: Optional[torch.Generator] = None, lam: Optional[torch.Tensor] = None,
           cy: Optional[torch.Tensor] = None,
           cx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paste a box (:func:`_cutmix_mask`) from the rolled partner; the label
    ratio is the kept area. ``alpha`` is unused: lam ~ Beta(1, 1), as in
    the reference's CutMix."""
    del alpha
    n, h, w = images.shape[:3]
    x = images.to(torch.float32)
    keep, ratio = _cutmix_mask(n, h, w, generator=generator, device=x.device,
                               lam=lam, cy=cy, cx=cx)
    mixed = keep * x + (1.0 - keep) * torch.roll(x, 1, 0)
    return mixed, torch.roll(labels, 1, 0), ratio


def mixup_and_cutmix(images: torch.Tensor, labels: torch.Tensor, *,
                     mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MixUp on the first half of the batch, CutMix on the second (each
    half rolls within itself). ``draws`` injects ``ratio`` (first half) and
    ``lam``, ``cy``, ``cx`` (second half)."""
    draws = draws or {}
    half = images.shape[0] // 2
    mu_x, mu_l, mu_r = mixup(images[:half], labels[:half], mixup_alpha,
                             generator=generator, ratio=draws.get("ratio"))
    cm_x, cm_l, cm_r = cutmix(images[half:], labels[half:], cutmix_alpha, generator=generator,
                              lam=draws.get("lam"), cy=draws.get("cy"), cx=draws.get("cx"))
    return (torch.cat([mu_x, cm_x]), torch.cat([mu_l, cm_l]), torch.cat([mu_r, cm_r]))


def apply_mixes(images: torch.Tensor, labels: torch.Tensor, spec, *,
                generator: Optional[torch.Generator] = None, draws: Optional[dict] = None):
    """The mixes an :class:`~sav_tpu_torch.data.augment_spec.AugmentSpec`
    selects. Returns ``(images_0_255, mix_labels | None, ratio | None)``;
    ``draws`` (``ratio``; ``lam``, ``cy``, ``cx``) replaces the draws."""
    draws = draws or {}
    if spec is None or not spec.mixes:
        return images.to(torch.float32), None, None
    if spec.cutmix and spec.mixup:
        return mixup_and_cutmix(images, labels, mixup_alpha=spec.mixup_alpha,
                                cutmix_alpha=spec.cutmix_alpha, generator=generator,
                                draws=draws)
    if spec.mixup:
        return mixup(images, labels, spec.mixup_alpha, generator=generator,
                     ratio=draws.get("ratio"))
    return cutmix(images, labels, spec.cutmix_alpha, generator=generator, lam=draws.get("lam"),
                  cy=draws.get("cy"), cx=draws.get("cx"))
