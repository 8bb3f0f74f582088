"""Batch-level CutMix and MixUp on the host (the port's own copy of
``sav_tpu/data/mix.py``), for pipelines without ``device_preprocess``.

Each example mixes with its roll-by-1 partner; MixUp draws one Beta(alpha,
alpha) ratio per example (two Gamma draws), CutMix pastes one box per
example whose side is ``sqrt(1 - lam)`` of the image's, lam ~ U(0, 1),
centred on a uniform pixel, with the kept area as the label ratio; the
combined policy runs MixUp on the first half of the batch and CutMix on
the second, each half rolling within itself. The mixes run on 0..255
float32 values before the normalize (with which they commute) and emit the
batch keys of the port's device mixes (:mod:`sav_tpu_torch.ops.preprocess`):
``mix_labels`` and ``ratio``.

A mix is first a plan (:func:`mix_plan`): each example's partner, its kind
(:data:`KEEP`, :data:`BLEND` with its ratio, :data:`BOX` with its box) and
its label ratio. :func:`apply_plan` carries it out in numpy, as TF's
``r·x + (1 - r)·roll(x)`` and ``keep·x + (1 - keep)·roll(x)`` form it; the
input pipeline hands the same plan to the native loader, which mixes,
normalizes and casts in one pass
(:func:`~sav_tpu_torch.data.native_loader.mix_normalize_batch`).

The draws come from the ``numpy.random.Generator`` the caller passes, in a
fixed order (the Beta ratios; then lam, the centres' rows and columns);
``draws`` injects them instead (``ratio``; ``lam``, ``cy``, ``cx``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_F32 = np.float32

KEEP, BLEND, BOX = 0, 1, 2


def _sample_beta(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    g1 = rng.gamma(alpha, size=n).astype(_F32)
    g2 = rng.gamma(alpha, size=n).astype(_F32)
    with np.errstate(invalid="ignore"):
        return np.nan_to_num(g1 / (g1 + g2), nan=0.5).astype(_F32)


def _empty_plan(n: int) -> dict:
    return {"partner": np.arange(n, dtype=np.int64), "kind": np.zeros(n, np.uint8),
            "ratio": np.ones(n, _F32), "box": np.zeros((n, 4), np.int32)}


def _roll_partners(lo: int, hi: int) -> np.ndarray:
    """Each example of ``[lo, hi)`` paired with the one before it, the first
    with the last (``roll(x, 1)`` of the slice)."""
    return np.roll(np.arange(lo, hi, dtype=np.int64), 1)


def _plan_mixup(plan: dict, lo: int, hi: int, alpha: float, rng, ratio) -> None:
    n = hi - lo
    ratio = _sample_beta(n, alpha, rng) if ratio is None else np.asarray(ratio, _F32)
    plan["partner"][lo:hi] = _roll_partners(lo, hi)
    plan["kind"][lo:hi] = BLEND
    plan["ratio"][lo:hi] = ratio


def _plan_cutmix(plan: dict, lo: int, hi: int, height: int, width: int, rng,
                 lam=None, cy=None, cx=None) -> None:
    n = hi - lo
    lam = rng.random(n, dtype=_F32) if lam is None else np.asarray(lam, _F32)
    cy = rng.integers(0, height, n) if cy is None else np.asarray(cy)
    cx = rng.integers(0, width, n) if cx is None else np.asarray(cx)
    cut = np.sqrt(_F32(1.0) - lam)
    cut_h = (cut * _F32(height)).astype(np.int32)
    cut_w = (cut * _F32(width)).astype(np.int32)
    cy, cx = cy.astype(np.int32), cx.astype(np.int32)
    box = np.stack([np.clip(cy - cut_h // 2, 0, height), np.clip(cy + cut_h // 2, 0, height),
                    np.clip(cx - cut_w // 2, 0, width), np.clip(cx + cut_w // 2, 0, width)],
                   axis=1).astype(np.int32)
    # The kept area as TF's reduce_mean of the keep mask: its (exact) f32
    # sum over the count.
    pasted = (box[:, 1] - box[:, 0]).clip(0) * (box[:, 3] - box[:, 2]).clip(0)
    plan["partner"][lo:hi] = _roll_partners(lo, hi)
    plan["kind"][lo:hi] = BOX
    plan["box"][lo:hi] = box
    plan["ratio"][lo:hi] = (height * width - pasted).astype(_F32) / _F32(height * width)


def mix_plan(n: int, height: int, width: int, spec, *,
             rng: Optional[np.random.Generator] = None,
             draws: Optional[dict] = None) -> Optional[dict]:
    """The plan of the mixes an
    :class:`~sav_tpu_torch.data.augment_spec.AugmentSpec` selects for a
    batch of ``n`` images of ``height`` × ``width``; None when it selects
    none. Keys: ``partner`` [n] int64, ``kind`` [n] uint8, ``ratio`` [n]
    float32 (the label ratio, and BLEND's pixel ratio), ``box`` [n, 4]
    int32 (y0, y1, x0, x1 of BOX's pasted region)."""
    draws = draws or {}
    if not spec.mixes:
        return None
    plan = _empty_plan(n)
    box_draws = {k: draws.get(k) for k in ("lam", "cy", "cx")}
    if spec.cutmix and spec.mixup:
        half = n // 2
        _plan_mixup(plan, 0, half, spec.mixup_alpha, rng, draws.get("ratio"))
        _plan_cutmix(plan, half, n, height, width, rng, **box_draws)
    elif spec.mixup:
        _plan_mixup(plan, 0, n, spec.mixup_alpha, rng, draws.get("ratio"))
    else:
        _plan_cutmix(plan, 0, n, height, width, rng, **box_draws)
    return plan


def apply_plan(images: np.ndarray, plan: dict) -> np.ndarray:
    """``[N, H, W, C]`` images (uint8 or 0..255 floats) mixed by ``plan``, as
    float32."""
    x = np.asarray(images, _F32)
    out = x.copy()
    y = x[plan["partner"]]
    blend = plan["kind"] == BLEND
    if blend.any():
        r = plan["ratio"][blend][:, None, None, None]
        out[blend] = r * x[blend] + (_F32(1.0) - r) * y[blend]
    for i in np.flatnonzero(plan["kind"] == BOX):
        y0, y1, x0, x1 = plan["box"][i]
        out[i, y0:y1, x0:x1] = y[i, y0:y1, x0:x1]
    return out


def _mixed(batch: dict, plan: dict) -> dict:
    return dict(batch, images=apply_plan(batch["images"], plan),
                mix_labels=np.asarray(batch["labels"])[plan["partner"]], ratio=plan["ratio"])


def mixup(batch: dict, alpha: float = 0.2, *, rng: Optional[np.random.Generator] = None,
          ratio: Optional[np.ndarray] = None) -> dict:
    """``images ← r·x + (1 - r)·roll(x)``, r ~ Beta(alpha, alpha) per example."""
    n = len(batch["images"])
    plan = _empty_plan(n)
    _plan_mixup(plan, 0, n, alpha, rng, ratio)
    return _mixed(batch, plan)


def cutmix(batch: dict, alpha: float = 1.0, *, rng: Optional[np.random.Generator] = None,
           lam=None, cy=None, cx=None) -> dict:
    """Paste a box from the rolled partner; the label ratio is the kept area.
    ``alpha`` is unused: lam ~ Beta(1, 1)."""
    del alpha
    n, h, w = np.shape(batch["images"])[:3]
    plan = _empty_plan(n)
    _plan_cutmix(plan, 0, n, h, w, rng, lam=lam, cy=cy, cx=cx)
    return _mixed(batch, plan)


def apply_mixes(batch: dict, spec, *, rng: Optional[np.random.Generator] = None,
                draws: Optional[dict] = None) -> dict:
    """The mixes an :class:`~sav_tpu_torch.data.augment_spec.AugmentSpec`
    selects, in numpy (the batch as it is when none)."""
    n, h, w = np.shape(batch["images"])[:3]
    plan = mix_plan(n, h, w, spec, rng=rng, draws=draws)
    return batch if plan is None else _mixed(batch, plan)
