"""Synthetic and fake data iterators (the port's own copy of
``sav_tpu/data/synthetic.py``, numpy only).

Zero batches with the pipeline's shapes for end-to-end runs, and random
batches whose class id is embedded as a brightness offset, so that a model
trained on them must show a falling loss.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def fake_data_iterator(
    *,
    batch_size: int,
    image_size: int = 224,
    num_classes: int = 1000,
    transpose: bool = False,
    dtype=np.float32,
) -> Iterator[dict]:
    """Infinite zero batches with the pipeline's exact output shapes
    (``transpose``: HWCN images, the trainer's ``transpose_images``)."""
    img_shape = (
        (image_size, image_size, 3, batch_size)
        if transpose
        else (batch_size, image_size, image_size, 3)
    )
    images = np.zeros(img_shape, dtype)
    labels = np.zeros((batch_size,), np.int32)
    while True:
        yield {"images": images, "labels": labels}


def synth_batch(
    *,
    seed: int,
    position: int,
    batch_size: int,
    image_size: int = 32,
    num_classes: int = 10,
    dtype=np.float32,
) -> dict:
    """The deterministic synthetic NHWC batch at schedule ``position``
    (1-indexed completed-step numbers): Philox keyed on ``(seed, position)``,
    so a batch is a pure function of its position, and the class id is
    embedded as a brightness offset."""
    key = np.array([seed & 0xFFFFFFFFFFFFFFFF, position], np.uint64)
    rng = np.random.Generator(np.random.Philox(key=key))
    labels = rng.integers(0, num_classes, (batch_size,), dtype=np.int32)
    images = rng.standard_normal((batch_size, image_size, image_size, 3)).astype(np.float32)
    images += (labels[:, None, None, None] / num_classes - 0.5) * 4.0
    return {"images": images.astype(dtype), "labels": labels}


def synth_resumable_iterator(
    *,
    seed: int,
    start_step: int = 0,
    batch_size: int,
    image_size: int = 32,
    num_classes: int = 10,
    num_batches: Optional[int] = None,
    dtype=np.float32,
) -> Iterator[dict]:
    """:func:`synth_batch` batches from position ``start_step + 1`` on:
    the ``--synth-data`` feed."""
    position = start_step
    produced = 0
    while num_batches is None or produced < num_batches:
        position += 1
        produced += 1
        yield synth_batch(
            seed=seed,
            position=position,
            batch_size=batch_size,
            image_size=image_size,
            num_classes=num_classes,
            dtype=dtype,
        )


def synthetic_data_iterator(
    *,
    batch_size: int,
    image_size: int = 32,
    num_classes: int = 10,
    transpose: bool = False,
    seed: int = 0,
    num_batches: Optional[int] = None,
    learnable: bool = True,
    dtype=np.float32,
) -> Iterator[dict]:
    """Random images with (optionally) label-correlated signal: with
    ``learnable=True`` the class id is a constant brightness offset."""
    rng = np.random.default_rng(seed)
    count = 0
    while num_batches is None or count < num_batches:
        images = rng.standard_normal((batch_size, image_size, image_size, 3)).astype(dtype)
        labels = rng.integers(0, num_classes, (batch_size,), dtype=np.int32)
        if learnable:
            images += (labels[:, None, None, None] / num_classes - 0.5) * 4.0
        if transpose:
            images = np.transpose(images, (1, 2, 3, 0))
        yield {"images": images.astype(dtype), "labels": labels}
        count += 1
