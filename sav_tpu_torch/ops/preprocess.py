"""Device-side image normalisation (port of ``sav_tpu/ops/preprocess.py``)."""

from __future__ import annotations

import functools

import torch

from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB


@functools.cache
def _statistics(device: torch.device) -> tuple:
    """MEAN_RGB and STDDEV_RGB as f32 tensors on ``device``, made once per
    device: a serving program captured as a CUDA graph must not copy them
    from the host on every call (a capture cannot hold such a copy)."""
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
