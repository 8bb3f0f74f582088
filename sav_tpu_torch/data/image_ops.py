"""uint8 image augmentation ops in numpy (the port's own copy of
``sav_tpu/data/image_ops.py``, which runs them as TF ops).

Every op takes and returns a ``[H, W, 3]`` uint8 array and follows the TF
op's arithmetic step for step: float32 intermediates, and float → uint8
casts that truncate (TF's ``tf.cast``) after a clip to 0..255. The
geometric ops map each output pixel through one projective transform to
its nearest input pixel (``ImageProjectiveTransformV3`` with NEAREST
interpolation: ``std::round``, half away from zero) and fill what falls
outside with ``fill``. :func:`cutout` takes its box centre from the
``numpy.random.Generator`` it is given.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_F32 = np.float32


def _to_u8(x: np.ndarray) -> np.ndarray:
    """Clip to 0..255 and truncate to uint8, as ``tf.cast(tf.clip_by_value(x,
    0, 255), tf.uint8)``."""
    return np.clip(x, _F32(0.0), _F32(255.0)).astype(np.uint8)


def blend(image_a: np.ndarray, image_b: np.ndarray, factor) -> np.ndarray:
    """``a + factor * (b - a)`` in float32, clipped to uint8; factor may
    exceed 1."""
    a = image_a.astype(_F32)
    b = image_b.astype(_F32)
    return _to_u8(a + _F32(factor) * (b - a))


# ---------------------------------------------------------------- geometric


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """``std::round`` of float32 values (in float64, where x + 0.5 is exact)."""
    x = x.astype(np.float64)
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int64)


def _affine(image: np.ndarray, transform: Sequence[float], fill: int = 128) -> np.ndarray:
    """One projective transform ``[a0, a1, a2, b0, b1, b2, c0, c1]`` (output
    → input) with nearest-pixel sampling and a constant fill."""
    h, w = image.shape[:2]
    t = np.asarray(transform, _F32)
    ys, xs = np.meshgrid(np.arange(h, dtype=_F32), np.arange(w, dtype=_F32), indexing="ij")
    projection = t[6] * xs + t[7] * ys + _F32(1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        in_x = (t[0] * xs + t[1] * ys + t[2]) / projection
        in_y = (t[3] * xs + t[4] * ys + t[5]) / projection
    ix = _round_half_away(in_x)
    iy = _round_half_away(in_y)
    inside = (projection != 0) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = np.full(image.shape, fill, np.uint8)
    out[inside] = image[iy[inside], ix[inside]]
    return out


def rotate(image: np.ndarray, degrees, fill: int = 128) -> np.ndarray:
    """Rotation about the image centre by ``degrees`` (float32 arithmetic)."""
    radians = _F32(degrees) * _F32(math.pi) / _F32(180.0)
    c, s = np.cos(radians, dtype=_F32), np.sin(radians, dtype=_F32)
    h, w = _F32(image.shape[0]), _F32(image.shape[1])
    cx, cy = (w - _F32(1.0)) / _F32(2.0), (h - _F32(1.0)) / _F32(2.0)
    tx = cx - c * cx + s * cy
    ty = cy - s * cx - c * cy
    return _affine(image, [c, -s, tx, s, c, ty, 0.0, 0.0], fill)


def shear_x(image: np.ndarray, level, fill: int = 128) -> np.ndarray:
    return _affine(image, [1.0, level, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], fill)


def shear_y(image: np.ndarray, level, fill: int = 128) -> np.ndarray:
    return _affine(image, [1.0, 0.0, 0.0, level, 1.0, 0.0, 0.0, 0.0], fill)


def translate_x(image: np.ndarray, pixels, fill: int = 128) -> np.ndarray:
    return _affine(image, [1.0, 0.0, -_F32(pixels), 0.0, 1.0, 0.0, 0.0, 0.0], fill)


def translate_y(image: np.ndarray, pixels, fill: int = 128) -> np.ndarray:
    return _affine(image, [1.0, 0.0, 0.0, 0.0, 1.0, -_F32(pixels), 0.0, 0.0], fill)


# -------------------------------------------------------------- photometric


def invert(image: np.ndarray) -> np.ndarray:
    return 255 - image


def posterize(image: np.ndarray, bits: int) -> np.ndarray:
    shift = np.uint8(8 - bits)
    return (image >> shift) << shift


def _threshold_u8(threshold: int) -> np.uint8:
    """``tf.cast(threshold, tf.uint8)``: 256 wraps to 0."""
    return np.uint8(int(threshold) & 0xFF)


def solarize(image: np.ndarray, threshold: int = 128) -> np.ndarray:
    return np.where(image < _threshold_u8(threshold), image, 255 - image)


def solarize_add(image: np.ndarray, addition: int, threshold: int = 128) -> np.ndarray:
    added = np.clip(image.astype(np.int32) + int(addition), 0, 255).astype(np.uint8)
    return np.where(image < _threshold_u8(threshold), added, image)


def _grayscale(image: np.ndarray) -> np.ndarray:
    """``tf.image.rgb_to_grayscale`` of uint8 RGB: to [0, 1] floats, the
    weights (0.2989, 0.5870, 0.1140), back to uint8 by ``x * 255.5``
    truncated; ``[H, W]``."""
    flt = image.astype(_F32) * _F32(1.0 / 255)
    gray = (flt[..., 0] * _F32(0.2989) + flt[..., 1] * _F32(0.5870)
            + flt[..., 2] * _F32(0.1140))
    return (gray * _F32(255.5)).astype(np.uint8)


def color(image: np.ndarray, factor) -> np.ndarray:
    gray = np.repeat(_grayscale(image)[..., None], 3, axis=-1)
    return blend(gray, image, factor)


def contrast(image: np.ndarray, factor) -> np.ndarray:
    gray = _grayscale(image)
    # The f32 sum of uint8 values is exact below 2**24 / 255 pixels, so any
    # summation order gives TF's mean.
    mean = _F32(gray.sum(dtype=np.float64)) / _F32(gray.size)
    flat = np.full(image.shape, np.uint8(mean), np.uint8)
    return blend(flat, image, factor)


def brightness(image: np.ndarray, factor) -> np.ndarray:
    return blend(np.zeros_like(image), image, factor)


def autocontrast(image: np.ndarray) -> np.ndarray:
    out = np.empty_like(image)
    for c in range(image.shape[-1]):
        ch = image[..., c].astype(_F32)
        lo, hi = ch.min(), ch.max()
        if hi > lo:
            ch = np.clip((ch - lo) * (_F32(255.0) / (hi - lo)), _F32(0.0), _F32(255.0))
        out[..., c] = ch.astype(np.uint8)
    return out


def equalize(image: np.ndarray) -> np.ndarray:
    out = np.empty_like(image)
    for c in range(image.shape[-1]):
        ch = image[..., c]
        hist = np.bincount(ch.ravel(), minlength=256).astype(np.int64)
        nonzero = hist[hist != 0]
        step = (int(nonzero.sum()) - int(nonzero[-1])) // 255
        if step == 0:
            out[..., c] = ch
            continue
        lut = (np.cumsum(hist) + step // 2) // step
        lut = np.concatenate([[step // 2 // step], lut[:-1]])
        out[..., c] = np.clip(lut, 0, 255)[ch]
    return out


def sharpness(image: np.ndarray, factor) -> np.ndarray:
    """Blend with a 3×3 smoothing (``[[1,1,1],[1,5,1],[1,1,1]] / 13``) of the
    interior; the border keeps the original pixels. The smoothing sums the
    taps in row-major order with one rounding per tap (a fused multiply-add,
    as TF's depthwise convolution does on the CPU)."""
    img = image.astype(_F32)
    h, w = img.shape[:2]
    kernel = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], _F32) / _F32(13.0)
    smoothed = np.zeros((h - 2, w - 2, img.shape[-1]), _F32)
    for dy in range(3):
        for dx in range(3):
            tap = img[dy: dy + h - 2, dx: dx + w - 2].astype(np.float64) * float(kernel[dy, dx])
            smoothed = (smoothed + tap).astype(_F32)
    out = img.copy()
    out[1:-1, 1:-1] = np.clip(smoothed, _F32(0.0), _F32(255.0))
    return blend(out.astype(np.uint8), image, factor)


def cutout(image: np.ndarray, pad_size: int, rng: np.random.Generator,
           fill: int = 128) -> np.ndarray:
    """Fill a ``2 * pad_size`` square (clipped to the image) centred on a
    uniform pixel with ``fill``."""
    h, w = image.shape[:2]
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    out = image.copy()
    out[max(cy - pad_size, 0): min(cy + pad_size, h),
        max(cx - pad_size, 0): min(cx + pad_size, w)] = fill
    return out
