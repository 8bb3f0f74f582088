"""Request-shaped inference preprocessing, uint8 end to end.

The port's own copy of ``sav_tpu/serve/preprocess.py`` (numpy only): the
training loader's eval ``crop_resize`` (an aspect-preserving center crop
padded by 32 px, a Keys bicubic resize, a truncating cast back to uint8)
for single requests. The wire format stays uint8 the whole way; the
engine's program normalises on the device with
:func:`sav_tpu_torch.ops.preprocess.normalize_images`, so one request ships
H*W*3 bytes.

Parity (tests/test_torch_serve_path.py): bit-equal to ``sav_tpu``'s
``preprocess_request`` on the same decoded images.
"""

from __future__ import annotations

import numpy as np

CROP_PADDING = 32  # the eval path's aspect-preserving crop margin


def center_crop_window(height: int, width: int, image_size: int) -> tuple:
    """(y, x, crop) of the eval center-crop — the TF path's exact
    integer arithmetic (pipeline.py ``_center_crop_window``)."""
    ratio = image_size / (image_size + CROP_PADDING)
    crop = int(ratio * min(height, width))
    y = (height - crop + 1) // 2
    x = (width - crop + 1) // 2
    return y, x, crop


def _cubic_weights(in_size: int, out_size: int) -> tuple:
    """4-tap Keys cubic (a=-0.5) sample weights with half-pixel centers.

    Returns ``(indices [out, 4] int, weights [out, 4] f64)``. Boundary
    handling matches TF's keys-cubic kernel: an out-of-range tap's
    weight is zeroed and the remaining weights renormalized to sum 1
    (NOT accumulated onto the clamped edge pixel — that variant is ~7
    uint8 levels off at the borders on noise images).
    """
    a = -0.5
    scale = in_size / out_size
    out = np.arange(out_size, dtype=np.float64)
    in_coord = (out + 0.5) * scale - 0.5
    base = np.floor(in_coord).astype(np.int64)
    frac = in_coord - base
    # Tap offsets -1..2 around the base pixel.
    offsets = np.arange(-1, 3, dtype=np.int64)
    indices = base[:, None] + offsets[None, :]
    x = np.abs(frac[:, None] - offsets[None, :])
    weights = np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(
            x < 2.0,
            a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a,
            0.0,
        ),
    )
    valid = (indices >= 0) & (indices < in_size)
    weights = weights * valid
    weights /= weights.sum(axis=1, keepdims=True)
    return np.clip(indices, 0, in_size - 1), weights


def _resize_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Separable 1-D cubic resample of ``image`` along ``axis`` (f64)."""
    in_size = image.shape[axis]
    if in_size == out_size:
        return image
    indices, weights = _cubic_weights(in_size, out_size)
    moved = np.moveaxis(image, axis, 0)
    # [out, 4, ...] taps -> weighted sum over the tap axis.
    taps = moved[indices]
    out = np.einsum("ot,ot...->o...", weights, taps)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_u8(image: np.ndarray, image_size: int) -> np.ndarray:
    """``tf.image.resize(..., BICUBIC)`` + clip + truncating uint8 cast,
    on numpy. Input uint8/float ``[H, W, C]``; output uint8
    ``[image_size, image_size, C]``."""
    out = _resize_axis(image.astype(np.float64), image_size, 0)
    out = _resize_axis(out, image_size, 1)
    # TF casts with tf.cast (truncation toward zero), not rounding.
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def preprocess_request(image: np.ndarray, image_size: int) -> np.ndarray:
    """Decoded uint8 ``[H, W, 3]`` image -> model-shaped uint8
    ``[image_size, image_size, 3]`` via the eval ``crop_resize`` recipe.

    The output is what :meth:`sav_tpu_torch.serve.engine.ServeEngine.submit`
    expects; normalization happens inside the compiled program, so this
    function never leaves uint8.
    """
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(
            f"expected a decoded [H, W, 3] image, got shape {image.shape}"
        )
    if image.dtype != np.uint8:
        raise ValueError(
            f"expected uint8 on the wire, got {image.dtype}; decode/clip "
            "to 0..255 uint8 first (the serving wire format is uint8 end "
            "to end — docs/serving.md)"
        )
    h, w = image.shape[0], image.shape[1]
    y, x, crop = center_crop_window(h, w, image_size)
    if crop < 1:
        raise ValueError(
            f"image {h}x{w} too small to crop for image_size {image_size}"
        )
    cropped = image[y : y + crop, x : x + crop]
    return resize_bicubic_u8(cropped, image_size)
