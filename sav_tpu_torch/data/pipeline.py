"""The host input pipeline of the port (its own copy of
``sav_tpu/data/pipeline.py``, without TensorFlow).

Same splits, sources, preprocessing and batch layouts as ``sav_tpu``:

  - ``Split`` with ImageNet's example counts (VALID is carved from the
    front of the train files, TEST is ``validation-*``), and per-host
    shards with ``np.array_split`` semantics;
  - sources: a TFRecord directory (:mod:`sav_tpu_torch.data.tfrecord`) or
    an in-memory ``(images, labels)`` pair, JPEG-encoded on the fly (PIL,
    quality 95, as ``tf.io.encode_jpeg``) so that tests run the bytes path;
  - train: an Inception-style distorted-bbox crop window, the decode of the
    window, a random flip and TF's half-pixel bicubic resize, then
    RandAugment / AutoAugment on uint8, CutMix / MixUp on the batch
    (:mod:`sav_tpu_torch.data.mix`), unless ``device_preprocess`` ships
    uint8 and the train step mixes on the card; eval: ``crop_resize`` or
    ``resize_crop_<pct>``;
  - batches NHWC or HWCN (``transpose``), normalized float32 or late bf16
    (a ``torch.bfloat16`` tensor), or uint8 with ``device_preprocess``.

Where ``sav_tpu`` leaves order and draws to tf.data and TF's random ops,
which cannot be reproduced, the port keys them: each epoch's order is
``default_rng([seed, epoch]).permutation`` of the host's shard, and every
example's draws (crop window, flip, augmentation) come from
``default_rng([seed, epoch, 0, example id])``, every batch's mix draws
from ``default_rng([seed, epoch, 1, batch index])``. So a batch is a pure
function of (seed, epoch, position): :func:`resumable_train_iterator`
resumed at step S gives, bit for bit, the batches an uninterrupted stream
gives from S, and skips the batches before S without decoding them. Each
example is seen once an epoch, host shards are disjoint, and
``epoch_mode`` drops the remainder.

The per-example work (decode, crop, resize, augment) runs on a pool of
worker processes (``spawn``; this module imports no torch, so a worker
starts with numpy and PIL only); the batch work (mixes, normalize, bf16
cast) runs in the calling process, the byte-heavy steps in the native
loader.

JPEG decode: PIL (libjpeg-turbo) decodes with the accurate integer DCT
(``JDCT_ISLOW``); TF's ``decode_jpeg`` defaults to the fast one, so the
two differ by a few levels of 255 on most pixels (the tests state the
bound); with ``dct_method="INTEGER_ACCURATE"`` TF's decode equals PIL's.
The bicubic resize equals TF's ``ResizeBicubic`` bit for bit.
"""

from __future__ import annotations

import collections
import enum
import io
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Generator, Optional, Sequence

import numpy as np

from sav_tpu_torch.data.augment_spec import parse_augment_spec
from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB

_F32 = np.float32
_STREAM_EXAMPLE = 0
_STREAM_MIX = 1
_STREAM_AFTER_MIX = 2
# Batches ``load`` keeps submitted to its workers beyond the one being
# assembled.
LOOKAHEAD = 2


class Split(enum.Enum):
    """ImageNet splits (the reference pipeline's semantics)."""

    TRAIN = 1
    TRAIN_AND_VALID = 2
    VALID = 3
    TEST = 4

    @property
    def num_examples(self) -> int:
        return {
            Split.TRAIN: 1_271_167,
            Split.TRAIN_AND_VALID: 1_281_167,
            Split.VALID: 10_000,
            Split.TEST: 50_000,
        }[self]


def _host_shard_range(split: Split, process_index: int, process_count: int,
                      split_examples: Optional[int] = None) -> tuple:
    """[start, end) of this host's examples within the split;
    ``split_examples`` replaces the ImageNet size for a custom dataset."""
    n = split.num_examples if split_examples is None else split_examples
    shard = np.array_split(np.arange(n), process_count)[process_index]
    return int(shard[0]), int(shard[-1]) + 1


def decoder_name() -> str:
    """The JPEG decoder the pipeline runs."""
    import PIL
    from PIL import features

    return (f"PIL {PIL.__version__} (libjpeg-turbo {features.version('libjpeg_turbo')}, "
            "accurate integer DCT)")


# --------------------------------------------------------------- decoding


def _open_jpeg(image_bytes: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(image_bytes))


def distorted_bbox_crop_window(shape: tuple, rng: np.random.Generator, *,
                               area_range: tuple = (0.08, 1.0),
                               aspect_ratio_range: tuple = (3.0 / 4.0, 4.0 / 3.0),
                               min_object_covered: float = 0.1,
                               max_attempts: int = 10) -> tuple:
    """An Inception-style crop window ``(y, x, h, w)`` of an image of
    ``shape = (height, width)``: TF's ``sample_distorted_bounding_box``
    algorithm with the whole image as the box, drawn from ``rng``. Each
    attempt draws an aspect ratio, then a height between those of the
    smallest and largest allowed areas, then the corner; a window must
    cover ``min_object_covered`` of the image. After ``max_attempts``
    misses the window is the whole image."""
    height, width = int(shape[0]), int(shape[1])
    min_area = _F32(area_range[0]) * _F32(width) * _F32(height)
    max_area = _F32(area_range[1]) * _F32(width) * _F32(height)
    for _ in range(max_attempts):
        aspect = _F32(rng.random() * (aspect_ratio_range[1] - aspect_ratio_range[0])
                      + aspect_ratio_range[0])
        h = int(np.rint(np.sqrt(min_area / aspect)))
        max_h = int(np.rint(np.sqrt(max_area / aspect)))
        if int(np.rint(max_h * aspect)) > width:
            max_h = int((width + 0.5 - 1e-7) / aspect)
            if int(np.rint(max_h * aspect)) > width:
                max_h -= 1
        max_h = min(max_h, height)
        h = min(h, max_h)
        if h < max_h:
            h += int(rng.integers(0, max_h - h + 1))
        w = int(np.rint(h * aspect))
        area = _F32(w * h)
        if area < min_area:
            h += 1
            w = int(np.rint(h * aspect))
            area = _F32(w * h)
        if (area < min_area or area > max_area or not 0 < w <= width
                or not 0 < h <= height or w * h < min_object_covered * width * height):
            continue
        y = int(rng.integers(0, height - h)) if h < height else 0
        x = int(rng.integers(0, width - w)) if w < width else 0
        return y, x, h, w
    return 0, 0, height, width


def center_crop_window(shape: tuple, image_size: int) -> tuple:
    """The aspect-preserving centre crop ``(y, x, crop, crop)``, padded by
    32 px: ``crop = size / (size + 32) · min(h, w)``."""
    h, w = int(shape[0]), int(shape[1])
    ratio = _F32(image_size) / (_F32(image_size) + _F32(32.0))
    crop = int(ratio * _F32(min(h, w)))
    return (h - crop + 1) // 2, (w - crop + 1) // 2, crop, crop


def _decode(image) -> np.ndarray:
    """A PIL image (or JPEG bytes) as uint8 RGB ``[H, W, 3]``."""
    if isinstance(image, (bytes, bytearray, memoryview)):
        image = _open_jpeg(bytes(image))
    if image.mode != "RGB":
        image = image.convert("RGB")
    return np.asarray(image)


def _decode_crop(image_bytes: bytes, window: Sequence[int]) -> np.ndarray:
    """The ``(y, x, h, w)`` window of the decoded image, uint8 RGB."""
    y, x, h, w = (int(v) for v in window)
    return _decode(image_bytes)[y: y + h, x: x + w]


_KEYS_TABLE = 1024


def _keys_cubic_table(a: float = -0.5) -> tuple:
    """TF's 1025-entry coefficient tables of the Keys cubic kernel (computed
    in double from float32 positions, stored as float32)."""
    x = (np.arange(_KEYS_TABLE + 1) * 1.0 / _KEYS_TABLE).astype(_F32).astype(np.float64)
    near = (((a + 2) * x - (a + 3)) * x * x + 1).astype(_F32)
    x = (x + 1.0).astype(_F32).astype(np.float64)
    far = (((a * x - 5 * a) * x + 8 * a) * x - 4 * a).astype(_F32)
    return near, far


_NEAR, _FAR = _keys_cubic_table()


def _bicubic_taps(in_size: int, out_size: int) -> tuple:
    """The four input indices ``[4, out]`` and float32 weights ``[4, out]``
    of each output position: TF's half-pixel ``ResizeBicubic`` (Keys a =
    -0.5, weights from the quantized table; taps outside the image get
    weight 0 and the rest are renormalized)."""
    scale = _F32(in_size) / _F32(out_size)
    loc = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * scale - _F32(0.5)
    base = np.floor(loc).astype(np.int64)
    offset = np.rint((loc - base.astype(_F32)) * _F32(_KEYS_TABLE)).astype(np.int64)
    index = np.stack([base - 1, base, base + 1, base + 2])
    weight = np.stack([_FAR[offset], _NEAR[offset], _NEAR[_KEYS_TABLE - offset],
                       _FAR[_KEYS_TABLE - offset]])
    weight = np.where((index >= 0) & (index < in_size), weight, _F32(0.0))
    total = ((weight[0] + weight[1]) + weight[2]) + weight[3]
    ok = np.abs(total) >= _F32(1000.0) * np.finfo(_F32).tiny
    weight = np.where(ok, weight * (_F32(1.0) / np.where(ok, total, _F32(1.0))), weight)
    return np.clip(index, 0, in_size - 1), weight.astype(_F32)


def resize_bicubic_f32(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """TF's ``tf.image.resize(..., BICUBIC)`` (no antialias) of an
    ``[H, W, C]`` image, float32 out. The resize is two banded weight
    matrices, ``out = Wy · img · Wxᵀ`` per channel, each row holding the
    four taps of :func:`_bicubic_taps`; it is applied along the rows
    first, then along the columns, each sum of four products formed left
    to right in float32 as TF forms it."""
    img = image.astype(_F32)
    y_index, y_weight = _bicubic_taps(img.shape[0], height)
    x_index, x_weight = _bicubic_taps(img.shape[1], width)
    rows = img[y_index[0]] * y_weight[0][:, None, None]
    for j in range(1, 4):
        rows = rows + img[y_index[j]] * y_weight[j][:, None, None]
    out = rows[:, x_index[0]] * x_weight[0][None, :, None]
    for i in range(1, 4):
        out = out + rows[:, x_index[i]] * x_weight[i][None, :, None]
    return out


def _resize_bicubic(image: np.ndarray, image_size: int) -> np.ndarray:
    """Bicubic resize to ``image_size`` square, clipped and truncated to
    uint8 (``sav_tpu``'s ``_resize_bicubic``)."""
    out = resize_bicubic_f32(image, image_size, image_size)
    return np.clip(out, _F32(0.0), _F32(255.0)).astype(np.uint8)


def _train_preprocess(image_bytes: bytes, image_size: int,
                      rng: Optional[np.random.Generator] = None, *,
                      area_range: tuple = (0.08, 1.0), random_flip: bool = True,
                      window: Optional[Sequence[int]] = None,
                      flip: Optional[bool] = None) -> np.ndarray:
    """Crop window, decode, flip and resize of one train example; the
    window and the flip are drawn from ``rng`` unless given."""
    image = _open_jpeg(image_bytes)
    if window is None:
        width, height = image.size
        window = distorted_bbox_crop_window((height, width), rng, area_range=area_range)
    y, x, h, w = window
    image = _decode(image)[y: y + h, x: x + w]
    if flip is None:
        flip = random_flip and bool(rng.random() < 0.5)
    if flip:
        image = image[:, ::-1]
    return _resize_bicubic(image, image_size)


def _eval_preprocess(image_bytes: bytes, image_size: int, eval_preproc: str) -> np.ndarray:
    """``crop_resize``: the centre crop window, resized; ``resize_crop_<pct>``:
    resize to ``size / pct``, then the centre ``size`` square (padded with
    zeros where the image is smaller)."""
    if eval_preproc == "crop_resize":
        image = _open_jpeg(image_bytes)
        width, height = image.size
        y, x, h, w = center_crop_window((height, width), image_size)
        return _resize_bicubic(_decode(image)[y: y + h, x: x + w], image_size)
    if eval_preproc.startswith("resize_crop_"):
        pct = float(eval_preproc[len("resize_crop_"):])
        resize_to = int(_F32(image_size) / _F32(pct))
        image = resize_bicubic_f32(_decode(image_bytes), resize_to, resize_to)
        out = np.zeros((image_size, image_size, image.shape[-1]), _F32)
        crop_y = max(resize_to - image_size, 0) // 2
        pad_y = max(image_size - resize_to, 0) // 2
        n = min(image_size, resize_to)
        out[pad_y: pad_y + n, pad_y: pad_y + n] = image[crop_y: crop_y + n, crop_y: crop_y + n]
        return np.clip(out, _F32(0.0), _F32(255.0)).astype(np.uint8)
    raise ValueError(f"unknown eval_preproc {eval_preproc!r}")


def _normalize(images: np.ndarray) -> np.ndarray:
    """``(x - MEAN_RGB) / STDDEV_RGB`` in float32."""
    return ((np.asarray(images, _F32) - np.asarray(MEAN_RGB, _F32))
            / np.asarray(STDDEV_RGB, _F32))


# ----------------------------------------------------------------- sources


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB → JPEG bytes (PIL; 4:2:0 chroma, as ``tf.io.encode_jpeg``)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(image, np.uint8)).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _encode_chunk(images: np.ndarray) -> list:
    return [encode_jpeg(image) for image in images]


class _MemorySource:
    """In-memory uint8 images ``[start, end)``, JPEG-encoded up front (on
    ``pool``'s workers when given)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, start: int, end: int,
                 pool=None):
        end = min(end, len(images))
        start = min(start, end)
        chunks = [images[lo: min(lo + 64, end)] for lo in range(start, end, 64)]
        encoded = pool.map(_encode_chunk, chunks) if pool is not None else map(_encode_chunk,
                                                                                chunks)
        self._encoded = [jpeg for chunk in encoded for jpeg in chunk]
        self._labels = np.asarray(labels[start:end]).astype(np.int32)

    def __len__(self) -> int:
        return len(self._encoded)

    def __getitem__(self, i: int) -> tuple:
        return self._encoded[i], int(self._labels[i])


def _source(split: Split, data_dir, source, start: int, end: int, split_examples, pool):
    if source is not None:
        return _MemorySource(source[0], source[1], start, end, pool)
    if data_dir is None:
        raise ValueError("need data_dir (a TFRecord directory) or source=(images, labels)")
    from sav_tpu_torch.data.tfrecord import TFRecordSource

    return TFRecordSource(split.name, data_dir, start, end,
                          custom_size=split_examples is not None)


# -------------------------------------------------------------------- load


def _workers() -> int:
    return min(8, os.cpu_count() or 1)


def _preprocess_examples(task: tuple) -> tuple:
    """One chunk of examples, on a worker: ``(images [k, H, W, 3] uint8,
    labels [k] int32)``. ``task = (items, params)``: ``items`` are
    ``(image bytes, label, draw key)``, the key None for eval; ``params``
    those of :func:`load` that shape an example."""
    items, params = task
    augment = None
    if params["augment_name"] is not None:
        from sav_tpu_torch.data.autoaugment import augment_fn

        augment = augment_fn(parse_augment_spec(params["augment_name"]))
    images = []
    for image_bytes, _, key in items:
        if key is None:
            images.append(_eval_preprocess(image_bytes, params["image_size"],
                                           params["eval_preproc"]))
            continue
        rng = np.random.default_rng(key)
        image = _train_preprocess(image_bytes, params["image_size"], rng,
                                  area_range=params["area_range"],
                                  random_flip=params["random_flip"])
        images.append(augment(image, rng) if augment is not None else image)
    return np.stack(images), np.asarray([label for _, label, _ in items], np.int32)


def load(
    split: Split,
    *,
    data_dir: Optional[str] = None,
    source: Optional[tuple] = None,
    is_training: bool,
    batch_dims: Sequence[int],
    image_size: int = 224,
    augment_name: Optional[str] = None,
    eval_preproc: str = "crop_resize",
    augment_before_mix: bool = True,
    transpose: bool = False,
    bfloat16: bool = False,
    fake_data: bool = False,
    seed: Optional[int] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    epoch_mode: bool = False,
    split_examples: Optional[int] = None,
    crop_area_range: tuple = (0.08, 1.0),
    random_flip: bool = True,
    device_preprocess: bool = False,
    start_batch: int = 0,
    num_workers: Optional[int] = None,
    executor: Optional[ProcessPoolExecutor] = None,
) -> Generator[dict, None, None]:
    """Batches of the split (module docstring): ``{'images', 'labels'}``,
    with ``mix_labels`` and ``ratio`` where the host mixes.

    ``batch_dims``: the leading batch shape, outermost first; a nested
    shape drops the remainder and, with ``transpose``, puts the innermost
    batch dim after the image dims (``[d0, H, W, C, d1]``).
    ``device_preprocess``: stop after the augment stage and ship uint8; the
    train step normalizes and mixes (incompatible with
    ``augment_before_mix=False``). ``epoch_mode``: one epoch, remainder
    dropped (the building block of :func:`resumable_train_iterator`);
    otherwise training repeats epochs 0, 1, ... and eval runs once, keeping
    a short last batch for a flat ``batch_dims``. ``start_batch``: the
    first batch of the (first) epoch to produce; the earlier ones are
    skipped without being decoded. ``num_workers``: the processes that
    decode, crop, resize and augment (default ``min(8, cpus)``, started
    with ``spawn``; 0 runs them in this process); ``executor``: a process
    pool to run them on instead, which the caller owns (a stream of
    epochs keeps one). The records are read, and the batches mixed,
    normalized and cast, here. A ``data_dir`` without TFRecords raises
    ``FileNotFoundError``."""
    if fake_data:
        yield from _fake_batches(batch_dims, image_size, transpose, bfloat16, device_preprocess)
        return
    total_batch = int(np.prod(batch_dims))
    pi = 0 if process_index is None else process_index
    pc = 1 if process_count is None else process_count
    start, end = _host_shard_range(split, pi, pc, split_examples)
    seed = 0 if seed is None else int(seed)

    spec = parse_augment_spec(augment_name) if is_training else None
    aug_after_mix = bool(is_training and not augment_before_mix and spec.mixes
                         and (spec.randaugment is not None or spec.autoaugment))
    if device_preprocess and aug_after_mix:
        raise ValueError("device_preprocess moves CutMix/MixUp into the train step, so the "
                         "host cannot re-augment mixed images; use augment_before_mix=True "
                         "(default) with device_preprocess")
    mixes = is_training and spec.mixes and not device_preprocess
    drop_remainder = is_training or len(batch_dims) > 1
    params = {"image_size": image_size, "eval_preproc": eval_preproc,
              "area_range": tuple(crop_area_range), "random_flip": random_flip,
              "augment_name": augment_name if is_training and not aug_after_mix else None}

    def submit(epoch: int, indices: np.ndarray) -> list:
        items = []
        for i in indices:
            image_bytes, label = examples[int(i)]
            key = [seed, epoch, _STREAM_EXAMPLE, int(i)] if is_training else None
            items.append((image_bytes, label, key))
        chunk = max(1, -(-len(items) // (2 * max(workers, 1))))
        tasks = [(items[lo: lo + chunk], params) for lo in range(0, len(items), chunk)]
        if pool is None:
            return [_Done(_preprocess_examples(task)) for task in tasks]
        return [pool.submit(_preprocess_examples, task) for task in tasks]

    def assemble(epoch: int, b: int, futures: list) -> dict:
        parts = [f.result() for f in futures]
        batch = {"images": np.concatenate([p[0] for p in parts]),
                 "labels": np.concatenate([p[1] for p in parts])}
        plan = None
        if mixes:
            from sav_tpu_torch.data.mix import apply_plan, mix_plan

            n, h, w = batch["images"].shape[:3]
            plan = mix_plan(n, h, w, spec,
                            rng=np.random.default_rng([seed, epoch, _STREAM_MIX, b]))
            batch["mix_labels"] = batch["labels"][plan["partner"]]
            batch["ratio"] = plan["ratio"]
            if aug_after_mix:
                # Re-quantize each mixed image to uint8, augment, as the
                # reference's augment-after-mix stage does.
                from sav_tpu_torch.data.autoaugment import augment_fn

                augment = augment_fn(spec)
                images = np.clip(apply_plan(batch["images"], plan), _F32(0.0),
                                 _F32(255.0)).astype(np.uint8)
                batch["images"] = np.stack([
                    augment(img, np.random.default_rng([seed, epoch, _STREAM_AFTER_MIX,
                                                        b * total_batch + k]))
                    for k, img in enumerate(images)])
                plan = None
        return _finalize(batch, batch_dims, transpose, bfloat16, device_preprocess, plan)

    def batches_of(epoch: int, first: int):
        n = len(examples)
        order = (np.random.default_rng([seed, epoch]).permutation(n) if is_training
                 else np.arange(n))
        limit = (n // total_batch) * total_batch if drop_remainder else n
        for b, lo in enumerate(range(0, limit, total_batch)):
            if b >= first:
                yield epoch, b, order[lo: lo + total_batch]

    def plan():
        epoch, first = 0, start_batch
        while True:
            yield from batches_of(epoch, first)
            if epoch_mode or not is_training:
                return
            epoch, first = epoch + 1, 0

    workers = _workers() if num_workers is None else int(num_workers)
    pool = executor
    if pool is None and workers > 0:
        pool = _process_pool(workers)
    pending: collections.deque = collections.deque()
    try:
        examples = _source(split, data_dir, source, start, end, split_examples, pool)
        for epoch, b, indices in plan():
            pending.append((epoch, b, submit(epoch, indices)))
            if len(pending) > LOOKAHEAD:
                yield assemble(*pending.popleft())
        while pending:
            yield assemble(*pending.popleft())
    finally:
        for _, _, futures in pending:
            for future in futures:
                future.cancel()
        if pool is not None and executor is None:
            pool.shutdown(wait=True, cancel_futures=True)


def _process_pool(workers: int) -> ProcessPoolExecutor:
    import multiprocessing

    return ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


class _Done:
    """A result computed in this process, read like a future's."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value

    def cancel(self) -> bool:
        return False


def _finalize(batch: dict, batch_dims, transpose: bool, bfloat16: bool,
              device_preprocess: bool, plan: Optional[dict] = None) -> dict:
    """Mix by ``plan``, normalize (or keep uint8 with ``device_preprocess``),
    lay out and cast a batch of ``[N, H, W, C]`` uint8 images."""
    # Imported here: it imports torch, which the workers never need.
    from sav_tpu_torch.data import native_loader as _nl

    images = batch["images"]
    lead = [int(d) for d in batch_dims]
    if device_preprocess:
        if len(lead) == 1 and transpose:
            images = np.ascontiguousarray(np.transpose(images, (1, 2, 3, 0)))
    elif len(lead) == 1:
        # Mix, normalize, transpose and cast in one native pass.
        images = _nl.mix_normalize_batch(images, MEAN_RGB, STDDEV_RGB, plan=plan,
                                         transpose=transpose, bfloat16=bfloat16)
    else:
        if plan is not None:
            from sav_tpu_torch.data.mix import apply_plan

            images = apply_plan(images, plan)
        images = _normalize(images)
    if len(lead) > 1:
        images = images.reshape(lead + list(images.shape[1:]))
        if transpose:
            rank = len(lead) + 3
            perm = list(range(len(lead) - 1)) + [*range(len(lead), rank), len(lead) - 1]
            images = np.ascontiguousarray(np.transpose(images, perm))
        batch["labels"] = batch["labels"].reshape(lead)
        for key in ("mix_labels", "ratio"):
            if key in batch:
                batch[key] = batch[key].reshape(lead)
        if bfloat16 and not device_preprocess:
            images = _nl.f32_to_bf16(images)
    batch["images"] = images
    return batch


def resumable_train_iterator(split: Split, *, start_step: int = 0,
                             steps_per_epoch: Optional[int] = None, seed: int = 0,
                             **load_kwargs) -> Generator[dict, None, None]:
    """A train stream over per-epoch pipelines: epoch e is ``load(...,
    epoch_mode=True, seed=(seed · 0x9E3779B1 + e) mod 2³¹)``, so a run
    restored at step S rebuilds epoch ``S // steps_per_epoch`` and starts
    ``S % steps_per_epoch`` batches into it; every example is seen as
    often as in the uninterrupted run, and the batches are bit for bit the
    uninterrupted stream's. ``steps_per_epoch``: batches per epoch on this
    host (default: from the split size; a shard smaller than one batch is
    refused)."""
    kwargs = dict(load_kwargs)
    kwargs.pop("epoch_mode", None)
    kwargs.pop("seed", None)
    kwargs.pop("start_batch", None)
    if steps_per_epoch is None:
        pi = kwargs.get("process_index")
        pc = kwargs.get("process_count")
        start, end = _host_shard_range(split, 0 if pi is None else pi, 1 if pc is None else pc,
                                       kwargs.get("split_examples"))
        total_batch = int(np.prod(kwargs["batch_dims"]))
        if kwargs.get("source") is not None:
            end = min(end, len(kwargs["source"][0]))
        steps_per_epoch = (end - start) // total_batch
        if steps_per_epoch < 1:
            raise ValueError(f"host shard of {end - start} examples is smaller than the "
                             f"per-host batch ({total_batch}); shrink the batch or use fewer "
                             "hosts")
    epoch = start_step // steps_per_epoch
    skip = start_step % steps_per_epoch
    # One pool of workers for every epoch's pipeline.
    workers = kwargs.pop("num_workers", None)
    workers = _workers() if workers is None else int(workers)
    pool = _process_pool(workers) if workers > 0 else None
    try:
        while True:
            produced = skip
            for batch in load(split, is_training=True, epoch_mode=True,
                              seed=(seed * 0x9E3779B1 + epoch) % (2**31), start_batch=skip,
                              num_workers=workers, executor=pool, **kwargs):
                if produced >= steps_per_epoch:
                    break
                produced += 1
                yield batch
            epoch += 1
            skip = 0
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def _fake_batches(batch_dims, image_size: int, transpose: bool, bfloat16: bool,
                  device_preprocess: bool = False):
    """Zero batches with the real path's shapes and dtypes, forever."""
    lead = [int(d) for d in batch_dims]
    img = [image_size, image_size, 3]
    if transpose:
        shape = img + [lead[0]] if len(lead) == 1 else lead[:-1] + img + [lead[-1]]
    else:
        shape = lead + img
    if device_preprocess:
        images = np.zeros(shape, np.uint8)
    elif bfloat16:
        import torch

        images = torch.zeros(shape, dtype=torch.bfloat16)
    else:
        images = np.zeros(shape, _F32)
    labels = np.zeros(lead, np.int32)
    while True:
        yield {"images": images, "labels": labels}
