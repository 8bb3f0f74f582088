"""TFRecord files of ``tf.train.Example`` images, read and written without
TensorFlow (the port's counterpart of ``sav_tpu``'s ``_tfrecord_source``).

Framing: each record is a little-endian u64 length, the masked CRC32C of
those 8 bytes, the payload and the masked CRC32C of the payload; both
checksums are checked (the native ``sav_crc32c``,
``sav_tpu_torch/native/tfrecord.cc``) and a mismatch raises. The payload
is a serialized ``tf.train.Example``; a small protobuf wire decoder reads
its ``image/encoded`` (bytes) and ``image/class/label`` (int64) features.

:class:`TFRecordSource` indexes the records of a split's files (sorted,
read back to back) with ``sav_tpu``'s carve-out: VALID is the first 10,000
records of ``train-*``, TRAIN skips them, TEST is ``validation-*``; then
this host's ``[start, end)`` of the split. ``custom_size`` (a dataset
sized by ``split_examples``) turns the carve-out off and reads 0-indexed
labels; ImageNet's are 1-indexed and shifted down by one.

:func:`write_tfrecord_examples` writes such a file, for tests and for
``chip_smoke.py``; no entry point calls it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
from typing import Optional, Sequence

import numpy as np

from sav_tpu_torch.data import _native_build

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_MASK_DELTA = 0xA282EAD8
_IMAGE_KEY = b"image/encoded"
_LABEL_KEY = b"image/class/label"
VALID_CARVE_OUT = 10_000


# -------------------------------------------------------------- checksums


def _crc_table() -> list:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


def crc32c(data: bytes, *, native: bool = True) -> int:
    """CRC32C (Castagnoli) of ``data``: the native slicing-by-8, or with
    ``native=False`` the bytewise table loop (the plain version)."""
    if native:
        lib = _native_build.load()
        if not getattr(lib, "_crc_bound", False):
            lib.sav_crc32c.restype = ctypes.c_uint32
            lib.sav_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib._crc_bound = True
        return int(lib.sav_crc32c(bytes(data), len(data)))
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in bytes(data):
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf wire format


def _varint(buf, pos: int) -> tuple:
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _fields(buf, start: int = 0, end: Optional[int] = None):
    """``(field number, wire type, value)`` of each field of a message:
    ``value`` an int for varints and fixed widths, a ``(start, end)`` span
    for length-delimited fields."""
    pos, end = start, len(buf) if end is None else end
    while pos < end:
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = int.from_bytes(buf[pos: pos + 8], "little"), pos + 8
        elif wire == 2:
            length, pos = _varint(buf, pos)
            value, pos = (pos, pos + length), pos + length
        elif wire == 5:
            value, pos = int.from_bytes(buf[pos: pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value
    if pos != end:
        raise ValueError("truncated protobuf message")


def _int64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def parse_example(record: bytes) -> tuple:
    """``(image bytes, label)`` of a serialized ``tf.train.Example`` with
    ``image/encoded`` (a one-value BytesList) and ``image/class/label`` (a
    one-value Int64List, packed or not)."""
    buf = memoryview(record)
    found: dict = {}
    for number, wire, features in _fields(buf):
        if number != 1 or wire != 2:
            continue
        for n_entry, w_entry, entry in _fields(buf, *features):
            if n_entry != 1 or w_entry != 2:
                continue
            key, feature = None, None
            for n, w, value in _fields(buf, *entry):
                if n == 1 and w == 2:
                    key = bytes(buf[value[0]: value[1]])
                elif n == 2 and w == 2:
                    feature = value
            if key in (_IMAGE_KEY, _LABEL_KEY) and feature is not None:
                found[key] = _feature_values(buf, feature)
    try:
        (image,) = found[_IMAGE_KEY]
        (label,) = found[_LABEL_KEY]
    except (KeyError, ValueError) as e:
        raise ValueError(f"not an image Example with one {_IMAGE_KEY.decode()} and one "
                         f"{_LABEL_KEY.decode()}") from e
    return image, label


def _feature_values(buf, span) -> list:
    """The values of a ``tf.train.Feature``: bytes for a BytesList, ints for
    an Int64List."""
    values = []
    for kind, wire, inner in _fields(buf, *span):
        if wire != 2:
            continue
        for n, w, value in _fields(buf, *inner):
            if n != 1:
                continue
            if kind == 1 and w == 2:
                values.append(bytes(buf[value[0]: value[1]]))
            elif kind == 3 and w == 0:
                values.append(_int64(value))
            elif kind == 3 and w == 2:  # packed
                pos, stop = value
                while pos < stop:
                    v, pos = _varint(buf, pos)
                    values.append(_int64(v))
    return values


def _encode_varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _length_delimited(number: int, payload: bytes) -> bytes:
    return _encode_varint(number << 3 | 2) + _encode_varint(len(payload)) + payload


def encode_example(image: bytes, label: int) -> bytes:
    """A serialized ``tf.train.Example`` with ``image/encoded`` and
    ``image/class/label`` (packed, as TF writes it)."""
    image_feature = _length_delimited(1, _length_delimited(1, bytes(image)))
    label_feature = _length_delimited(3, _length_delimited(1, _encode_varint(int(label))))
    entries = b"".join(
        _length_delimited(1, _length_delimited(1, key) + _length_delimited(2, feature))
        for key, feature in ((_IMAGE_KEY, image_feature), (_LABEL_KEY, label_feature)))
    return _length_delimited(1, entries)


# ------------------------------------------------------------ record files


def write_tfrecord_examples(path: str, jpeg_bytes: Sequence[bytes], labels) -> None:
    """Write one TFRecord file of image Examples (through a temporary file,
    renamed when complete)."""
    labels = np.asarray(labels)
    if len(jpeg_bytes) != len(labels):
        raise ValueError(f"{len(jpeg_bytes)} images but {len(labels)} labels")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for image, label in zip(jpeg_bytes, labels):
            record = encode_example(image, int(label))
            header = _U64.pack(len(record))
            f.write(header + _U32.pack(masked_crc32c(header)) + record
                    + _U32.pack(masked_crc32c(record)))
    os.replace(tmp, path)


def _index_file(path: str, limit: int) -> list:
    """``(payload offset, length)`` of the first ``limit`` records of a
    file, each length's checksum checked."""
    out = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        pos = 0
        while pos < size and len(out) < limit:
            head = f.read(12)
            if len(head) != 12:
                raise ValueError(f"truncated TFRecord header at byte {pos} of {path}")
            header = head[:8]
            if _U32.unpack(head[8:])[0] != masked_crc32c(header):
                raise ValueError(f"corrupted TFRecord length checksum at byte {pos} of {path}")
            length = _U64.unpack(header)[0]
            if pos + 16 + length > size:
                raise ValueError(f"truncated TFRecord at byte {pos} of {path}")
            out.append((pos + 12, length))
            pos += 16 + length
            f.seek(pos)
    return out


class TFRecordSource:
    """Random access to this host's ``[start, end)`` of a split's records
    (module docstring): ``source[i]`` is ``(image bytes, label)``, the
    payload checksum checked on every read."""

    PATTERNS = {"TRAIN": "train-*", "TRAIN_AND_VALID": "train-*", "VALID": "train-*",
                "TEST": "validation-*"}

    def __init__(self, split_name: str, data_dir: str, start: int, end: int, *,
                 custom_size: bool = False):
        pattern = self.PATTERNS[split_name]
        files = sorted(glob.glob(os.path.join(data_dir.rstrip("/"), pattern)))
        if not files:
            raise FileNotFoundError(f"no TFRecords matching {pattern} under {data_dir}")
        offset = VALID_CARVE_OUT if (split_name == "TRAIN" and not custom_size) else 0
        skip, take = offset + start, max(end - start, 0)
        self._files = files
        self._records: list = []  # (file index, payload offset, length)
        seen = 0
        for i, path in enumerate(files):
            if len(self._records) >= take:
                break
            for pos, length in _index_file(path, skip + take - seen):
                if seen >= skip:
                    self._records.append((i, pos, length))
                seen += 1
        self.label_shift = 0 if custom_size else 1

    def __len__(self) -> int:
        return len(self._records)

    def read(self, i: int) -> bytes:
        """The payload of record ``i``, its checksum checked."""
        file_index, pos, length = self._records[i]
        with open(self._files[file_index], "rb") as f:
            f.seek(pos)
            data = f.read(length + 4)
        record, crc = data[:length], data[length:]
        if len(crc) != 4 or _U32.unpack(crc)[0] != masked_crc32c(record):
            raise ValueError(f"corrupted TFRecord data checksum in record {i} "
                             f"({self._files[file_index]}, byte {pos})")
        return record

    def __getitem__(self, i: int) -> tuple:
        image, label = parse_example(self.read(i))
        return image, label - self.label_shift
