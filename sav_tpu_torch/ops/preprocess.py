"""Device-side image normalisation (port of ``sav_tpu/ops/preprocess.py``)."""

from __future__ import annotations

import torch

from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB


def normalize_images(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(x - MEAN_RGB) / STDDEV_RGB`` on 0..255 NHWC input, cast to ``dtype``.

    The arithmetic runs in f32 before the cast, so uint8 and pre-floated
    inputs give identical values (as in ``sav_tpu``).
    """
    x = images.to(torch.float32)
    mean = torch.tensor(MEAN_RGB, dtype=torch.float32, device=x.device)
    std = torch.tensor(STDDEV_RGB, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)
