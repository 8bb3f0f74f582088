"""SavRecord: the on-disk dataset format of ``sav_tpu``, read and written by
the port (its own copy of ``sav_tpu/data/records.py``).

A mmap'd fixed-shape image/label container read by the threaded C++ gather
in ``sav_tpu_torch/native/records.cc`` (ctypes, GIL released). Python owns
the policy (epoch shuffling, per-host sharding with ``np.array_split``
semantics, batch assembly) and C++ the byte movement. A file written by
either package is read by the other, and the same seed and host shards
give the same batches.

Format v1 (little-endian): magic ``SAVREC01``, u32 version 1, u32
reserved, u64 record count, u32 height, width, channels, label bytes (4),
then u64 payload-relative offsets [count + 1] and the payload: per record
the image bytes (h·w·c uint8) then the int32 label.

Usage::

    write_savrec("train.savrec", images_u8, labels)
    ds = SavRecDataset("train.savrec")
    for batch in savrec_epoch_iterator(ds, batch_size=256, seed=0):
        ...  # {'images': u8 [B,H,W,C], 'labels': i32 [B]}
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterator, Optional

import numpy as np

from sav_tpu_torch.data import native_loader as _nl
from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB

_MAGIC = b"SAVREC01"
_HEADER = struct.Struct("<8sII Q IIII")  # magic, version, reserved, n, h, w, c, label_bytes


def write_savrec(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Serialize uint8 images ``[N,H,W,C]`` and int labels ``[N]`` to
    ``path`` (through a temporary file, renamed when complete)."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    if images.ndim != 4 or labels.shape != (images.shape[0],):
        raise ValueError(f"expected images [N,H,W,C] u8 and labels [N], got "
                         f"{images.shape} / {labels.shape}")
    n, h, w, c = images.shape
    image_bytes = h * w * c
    rec_bytes = image_bytes + 4
    offsets = np.arange(n + 1, dtype=np.uint64) * rec_bytes
    tmp = path + ".tmp"
    # Image and label bytes interleaved in chunks: O(chunk) extra memory.
    chunk = max(1, (64 << 20) // rec_bytes)
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, 0, n, h, w, c, 4))
        offsets.tofile(f)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            payload = np.empty((hi - lo, rec_bytes), np.uint8)
            payload[:, :image_bytes] = images[lo:hi].reshape(hi - lo, image_bytes)
            payload[:, image_bytes:] = labels[lo:hi].view(np.uint8).reshape(hi - lo, 4)
            payload.tofile(f)
    os.replace(tmp, path)


def _bind(lib) -> None:
    if getattr(lib, "_savrec_bound", False):
        return
    lib.sav_rec_open.restype = ctypes.c_void_p
    lib.sav_rec_open.argtypes = [ctypes.c_char_p]
    lib.sav_rec_count.restype = ctypes.c_int64
    lib.sav_rec_count.argtypes = [ctypes.c_void_p]
    lib.sav_rec_meta.restype = None
    lib.sav_rec_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.sav_rec_read_batch.restype = ctypes.c_int
    lib.sav_rec_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.sav_rec_close.restype = None
    lib.sav_rec_close.argtypes = [ctypes.c_void_p]
    lib._savrec_bound = True


class SavRecDataset:
    """Random-access reader: the native mmap and threaded gather, or with
    ``native=False`` a numpy memmap (the plain version, with the same
    validation)."""

    def __init__(self, path: str, *, num_threads: Optional[int] = None, native: bool = True):
        self.path = path
        self._threads = num_threads
        self._handle = None
        if native:
            lib = _nl._lib()
            _bind(lib)
            handle = lib.sav_rec_open(os.fsencode(path))
            if not handle:
                raise ValueError(f"not a readable SavRecord v1 file: {path}")
            self._handle, self._lib = handle, lib
            meta = (ctypes.c_int64 * 4)()
            lib.sav_rec_meta(handle, meta)
            self._n = int(lib.sav_rec_count(handle))
            self.image_shape = (int(meta[0]), int(meta[1]), int(meta[2]))
        else:
            self._open_plain(path)

    def _open_plain(self, path: str) -> None:
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise ValueError(f"not a readable SavRecord v1 file: {path}")
        magic, version, _, n, h, w, c, label_bytes = _HEADER.unpack(head)
        if magic != _MAGIC or version != 1:
            raise ValueError(f"not a readable SavRecord v1 file: {path}")
        # The native open's checks: an overflow-safe truncation check and a
        # scan of the offsets table (monotonic, fixed record size).
        file_len = os.path.getsize(path)
        image_bytes = h * w * c
        rec_bytes = image_bytes + label_bytes
        if (rec_bytes == 0 or n > (file_len - _HEADER.size) // 8 - 1
                or file_len < _HEADER.size + (n + 1) * 8 + n * rec_bytes):
            raise ValueError(f"not a readable SavRecord v1 file: {path}")
        offsets = np.memmap(path, np.uint64, mode="r", offset=_HEADER.size, shape=(n + 1,))
        if int(offsets[0]) != 0 or not np.all(np.diff(offsets) == rec_bytes):
            raise ValueError(f"not a readable SavRecord v1 file: {path}")
        self._n = int(n)
        self.image_shape = (h, w, c)
        raw = np.memmap(path, np.uint8, mode="r", offset=_HEADER.size + (n + 1) * 8)
        self._plain_records = raw[: n * rec_bytes].reshape(n, rec_bytes)
        self._image_bytes = image_bytes

    def __len__(self) -> int:
        return self._n

    @property
    def native(self) -> bool:
        return self._handle is not None

    def read_batch(self, indices: np.ndarray) -> dict:
        """Gather records by index → ``{'images': u8 [B,H,W,C], 'labels': i32 [B]}``."""
        indices = np.ascontiguousarray(indices, np.int64)
        b = indices.shape[0]
        h, w, c = self.image_shape
        if self._handle is not None:
            images = np.empty((b, h, w, c), np.uint8)
            labels = np.empty((b,), np.int32)
            rc = self._lib.sav_rec_read_batch(
                self._handle, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                _nl._threads(self._threads))
            if rc != 0:
                raise IndexError(f"record index out of range (0..{self._n - 1})")
        else:
            if indices.min(initial=0) < 0 or indices.max(initial=-1) >= self._n:
                raise IndexError(f"record index out of range (0..{self._n - 1})")
            recs = self._plain_records[indices]
            images = recs[:, : self._image_bytes].reshape(b, h, w, c).copy()
            labels = recs[:, self._image_bytes:].copy().view(np.int32).reshape(b)
        return {"images": images, "labels": labels}

    def close(self) -> None:
        if self._handle is not None:
            self._lib.sav_rec_close(self._handle)
            self._handle = None

    def __enter__(self) -> "SavRecDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # the handle of a dataset never closed
        try:
            self.close()
        except Exception:
            pass


def host_shard_indices(n: int, host_id: int, host_count: int) -> np.ndarray:
    """This host's example indices: ``np.array_split`` of ``range(n)``."""
    if not 0 <= host_id < host_count:
        raise ValueError(f"host_id {host_id} not in [0, {host_count})")
    return np.array_split(np.arange(n, dtype=np.int64), host_count)[host_id]


def savrec_epoch_iterator(dataset: SavRecDataset, *, batch_size: int, shuffle: bool = True,
                          seed: int = 0, host_id: int = 0, host_count: int = 1,
                          drop_remainder: bool = True, num_epochs: Optional[int] = None,
                          start_epoch: int = 0) -> Iterator[dict]:
    """Host-sharded batches, reshuffled each epoch by
    ``default_rng([seed, epoch])``, so a run resumed at ``start_epoch``
    replays the same order."""
    shard = host_shard_indices(len(dataset), host_id, host_count)
    if drop_remainder and len(shard) < batch_size:
        raise ValueError(f"host shard has {len(shard)} records < batch_size {batch_size} "
                         "with drop_remainder=True: no batch would ever be yielded")
    epoch = start_epoch
    while num_epochs is None or epoch < start_epoch + num_epochs:
        order = np.random.default_rng([seed, epoch]).permutation(shard) if shuffle else shard
        limit = (len(order) // batch_size) * batch_size if drop_remainder else len(order)
        for lo in range(0, limit, batch_size):
            yield dataset.read_batch(order[lo: lo + batch_size])
        epoch += 1


def savrec_train_iterator(dataset: SavRecDataset, *, batch_size: int, normalize: bool = True,
                          mean=None, stddev=None, transpose: bool = False,
                          bfloat16: bool = False, flip: bool = True,
                          **epoch_kwargs) -> Iterator[dict]:
    """Trainer-ready batches through the native path: record gather, a
    random horizontal flip (``default_rng([seed + 1, epoch])``), the
    threaded normalize (with the HWCN transpose fused) and the late bf16
    cast (a ``torch.bfloat16`` tensor). With ``normalize=False`` it ships
    the flipped uint8 NHWC batch (the ``device_preprocess`` wire format)."""
    if transpose and not normalize:
        raise ValueError("transpose=True requires normalize=True (the transpose is fused into "
                         "the C++ normalize); the raw uint8 path ships NHWC: use "
                         "transpose_images=False with device_preprocess")
    mean = MEAN_RGB if mean is None else mean
    stddev = STDDEV_RGB if stddev is None else stddev
    seed = epoch_kwargs.pop("seed", 0)
    start_epoch = epoch_kwargs.pop("start_epoch", 0)
    num_epochs = epoch_kwargs.pop("num_epochs", None)
    epoch = start_epoch
    # One epoch at a time so the flip draws, like the shuffle, are seeded
    # by (seed, epoch).
    while num_epochs is None or epoch < start_epoch + num_epochs:
        flip_rng = np.random.default_rng([seed + 1, epoch])
        for batch in savrec_epoch_iterator(dataset, batch_size=batch_size, seed=seed,
                                           start_epoch=epoch, num_epochs=1, **epoch_kwargs):
            images = batch["images"]
            if flip:
                images = _nl.passthrough_batch_u8(images,
                                                  flip=flip_rng.random(images.shape[0]) < 0.5)
            if normalize:
                images = _nl.normalize_batch(images, mean, stddev, transpose=transpose)
                if bfloat16:
                    images = _nl.f32_to_bf16(images)
            yield {"images": images, "labels": batch["labels"]}
        epoch += 1
