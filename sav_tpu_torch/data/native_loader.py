"""ctypes bindings of the native loader core and a threaded prefetcher (the
port's own copy of ``sav_tpu/data/native_loader.py``).

The C++ library (``sav_tpu_torch/native/loader.cc``, built with ``g++`` at
first use by :mod:`sav_tpu_torch.data._native_build`) runs the host-side
hot loop of the input pipeline: normalize, the HWCN transpose, the late
bf16 cast, batch gather and the uint8 flip-and-assemble. ctypes calls
release the GIL, so :class:`PrefetchLoader`'s worker overlaps this byte
work with device steps.

Every entry point runs the library; one that cannot be built raises
rather than falling back. ``native=False`` runs ``sav_tpu``'s numpy
version instead, the plain version the tests hold the library against.
``sav_tpu`` returns ``ml_dtypes.bfloat16`` arrays; :func:`f32_to_bf16`
returns the same round-to-nearest-even bits as a ``torch.bfloat16``
tensor.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional

import numpy as np
import torch

from sav_tpu_torch.data import _native_build
from sav_tpu_torch.data.feeder import DeviceFeeder

_C_F32P = ctypes.POINTER(ctypes.c_float)
_C_U8P = ctypes.POINTER(ctypes.c_uint8)
_C_U16P = ctypes.POINTER(ctypes.c_uint16)
_C_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    """The built library with every loader entry point's signature bound."""
    lib = _native_build.load()
    if not getattr(lib, "_loader_bound", False):
        lib.sav_normalize_batch.restype = None
        lib.sav_normalize_batch.argtypes = [
            _C_U8P, _C_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _C_F32P, _C_F32P, ctypes.c_int, ctypes.c_int,
        ]
        lib.sav_f32_to_bf16.restype = None
        lib.sav_f32_to_bf16.argtypes = [_C_F32P, _C_U16P, ctypes.c_int64, ctypes.c_int]
        lib.sav_gather_batch.restype = None
        lib.sav_gather_batch.argtypes = [
            _C_U8P, _C_I32P, _C_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.sav_transpose_nhwc_to_hwcn.restype = None
        lib.sav_transpose_nhwc_to_hwcn.argtypes = [
            _C_F32P, _C_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.sav_mix_normalize_batch.restype = None
        lib.sav_mix_normalize_batch.argtypes = [
            _C_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), _C_U8P, _C_F32P, _C_I32P, _C_F32P, _C_F32P,
            ctypes.c_int, _C_F32P, _C_U16P, ctypes.c_int,
        ]
        lib.sav_u8_passthrough_batch.restype = None
        lib.sav_u8_passthrough_batch.argtypes = [
            _C_U8P, _C_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _C_U8P, ctypes.c_int,
        ]
        lib._loader_bound = True
    return lib


def native_available() -> bool:
    """True when the native library builds (or is built) and loads with ABI
    version 1."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _threads(n: Optional[int]) -> int:
    return n if n is not None else min(8, os.cpu_count() or 1)


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctype)


def normalize_batch(images: np.ndarray, mean, stddev, *, transpose: bool = False,
                    num_threads: Optional[int] = None, native: bool = True) -> np.ndarray:
    """uint8 [N,H,W,C] → normalized float32 ([N,H,W,C], or HWCN with
    ``transpose``): ``(x - mean[c]) * (1 / std[c])`` natively, ``(x - mean)
    / std`` in numpy."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected uint8 [N,H,W,C], got {images.dtype} {images.shape}")
    n, h, w, c = images.shape
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    stddev = np.ascontiguousarray(np.broadcast_to(np.asarray(stddev, np.float32), (c,)))
    if not native:
        out = (images.astype(np.float32) - mean) / stddev
        return np.transpose(out, (1, 2, 3, 0)) if transpose else out
    lib = _lib()
    images = np.ascontiguousarray(images)
    out = np.empty((h, w, c, n) if transpose else (n, h, w, c), np.float32)
    lib.sav_normalize_batch(_ptr(images, _C_U8P), _ptr(out, _C_F32P), n, h, w, c,
                            _ptr(mean, _C_F32P), _ptr(stddev, _C_F32P), int(transpose),
                            _threads(num_threads))
    return out


def f32_to_bf16(x: np.ndarray, *, num_threads: Optional[int] = None,
                native: bool = True) -> torch.Tensor:
    """float32 → bfloat16 (round-to-nearest-even, NaN kept quiet), as a
    ``torch.bfloat16`` tensor over the uint16 bits."""
    x = np.ascontiguousarray(x, np.float32)
    if native:
        out = np.empty(x.shape, np.uint16)
        _lib().sav_f32_to_bf16(_ptr(x, _C_F32P), _ptr(out, _C_U16P), x.size,
                               _threads(num_threads))
    else:
        bits = x.view(np.uint32)
        nan = ((bits & 0x7F800000) == 0x7F800000) & ((bits & 0x007FFFFF) != 0)
        rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
        out = np.where(nan, (bits >> 16) | 0x0040, rounded).astype(np.uint16)
    return torch.from_numpy(out).view(torch.bfloat16)


def mix_normalize_batch(images: np.ndarray, mean, stddev, *, plan: Optional[dict] = None,
                        transpose: bool = False, bfloat16: bool = False,
                        num_threads: Optional[int] = None, native: bool = True):
    """The input pipeline's batch stage in one pass: uint8 [N,H,W,C] images
    mixed by ``plan`` (:func:`sav_tpu_torch.data.mix.mix_plan`; None mixes
    nothing), normalized as ``(x - mean) / std`` in float32, laid out NHWC
    or HWCN (``transpose``), as float32 numpy or, with ``bfloat16``, a
    ``torch.bfloat16`` tensor. ``native=False`` runs
    :func:`~sav_tpu_torch.data.mix.apply_plan`, the numpy normalize and the
    plain bf16 cast: the same bits."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected uint8 [N,H,W,C], got {images.dtype} {images.shape}")
    n, h, w, c = images.shape
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    stddev = np.ascontiguousarray(np.broadcast_to(np.asarray(stddev, np.float32), (c,)))
    if not native:
        from sav_tpu_torch.data.mix import apply_plan

        x = apply_plan(images, plan) if plan is not None else images.astype(np.float32)
        out = (x - mean) / stddev
        if transpose:
            out = np.ascontiguousarray(np.transpose(out, (1, 2, 3, 0)))
        return f32_to_bf16(out, native=False) if bfloat16 else out
    if plan is None:
        from sav_tpu_torch.data.mix import _empty_plan

        plan = _empty_plan(n)
    partner = np.ascontiguousarray(plan["partner"], np.int64)
    kind = np.ascontiguousarray(plan["kind"], np.uint8)
    ratio = np.ascontiguousarray(plan["ratio"], np.float32)
    box = np.ascontiguousarray(plan["box"], np.int32)
    if partner.shape != (n,) or partner.min(initial=0) < 0 or partner.max(initial=0) >= n:
        raise IndexError(f"plan partners out of range [0, {n})")
    images = np.ascontiguousarray(images)
    shape = (h, w, c, n) if transpose else (n, h, w, c)
    out_f32 = None if bfloat16 else np.empty(shape, np.float32)
    out_bf16 = np.empty(shape, np.uint16) if bfloat16 else None
    _lib().sav_mix_normalize_batch(
        _ptr(images, _C_U8P), n, h, w, c, partner.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _ptr(kind, _C_U8P), _ptr(ratio, _C_F32P), _ptr(box, _C_I32P), _ptr(mean, _C_F32P),
        _ptr(stddev, _C_F32P), int(transpose),
        None if out_f32 is None else _ptr(out_f32, _C_F32P),
        None if out_bf16 is None else _ptr(out_bf16, _C_U16P), _threads(num_threads))
    return torch.from_numpy(out_bf16).view(torch.bfloat16) if bfloat16 else out_f32


def passthrough_batch_u8(images: np.ndarray, *, flip: Optional[np.ndarray] = None,
                         num_threads: Optional[int] = None, native: bool = True) -> np.ndarray:
    """uint8 [N,H,W,C] → a fresh uint8 [N,H,W,C] batch, with the W axis of
    image i reversed where ``flip[i]`` (a bool/uint8 [N] mask) is set: the
    uint8 wire format's only host byte transform."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected uint8 [N,H,W,C], got {images.dtype} {images.shape}")
    n, h, w, c = images.shape
    if flip is not None:
        flip = np.ascontiguousarray(np.asarray(flip).astype(np.uint8).reshape(n))
    if not native:
        if flip is None:
            return images.copy(order="C")
        return np.where(flip.astype(bool)[:, None, None, None], images[:, :, ::-1], images)
    images = np.ascontiguousarray(images)
    out = np.empty_like(images)
    _lib().sav_u8_passthrough_batch(_ptr(images, _C_U8P), _ptr(out, _C_U8P), n, h, w, c,
                                    None if flip is None else _ptr(flip, _C_U8P),
                                    _threads(num_threads))
    return out


def gather_batch(pool: np.ndarray, indices: np.ndarray, *,
                 num_threads: Optional[int] = None, native: bool = True) -> np.ndarray:
    """``out[i] = pool[indices[i]]`` for contiguous fixed-size items; indices
    must lie in ``[0, len(pool))`` (no numpy wrap-around)."""
    indices = np.ascontiguousarray(indices, np.int32)
    if indices.size and (indices.min() < 0 or indices.max() >= len(pool)):
        raise IndexError(f"indices out of range [0, {len(pool)}): "
                         f"[{indices.min()}, {indices.max()}]")
    if not native:
        return pool[indices].copy()
    pool = np.ascontiguousarray(pool)
    out = np.empty((len(indices),) + pool.shape[1:], pool.dtype)
    _lib().sav_gather_batch(_ptr(pool, _C_U8P), _ptr(indices, _C_I32P), _ptr(out, _C_U8P),
                            len(indices), pool[0].nbytes, _threads(num_threads))
    return out


def transpose_nhwc_to_hwcn(x: np.ndarray, *, num_threads: Optional[int] = None,
                           native: bool = True) -> np.ndarray:
    """float32 NHWC → a contiguous float32 HWCN copy."""
    x = np.ascontiguousarray(x, np.float32)
    if not native:
        return np.transpose(x, (1, 2, 3, 0)).copy()
    n, h, w, c = x.shape
    out = np.empty((h, w, c, n), np.float32)
    _lib().sav_transpose_nhwc_to_hwcn(_ptr(x, _C_F32P), _ptr(out, _C_F32P), n, h, w, c,
                                      _threads(num_threads))
    return out


class PrefetchLoader(DeviceFeeder):
    """Bounded background prefetch over any host batch iterator, in order:
    a host-only :class:`~sav_tpu_torch.data.feeder.DeviceFeeder` whose
    ``place_fn`` is ``transform`` (default: the batch as it is), so it
    shares the feeder's drain, error propagation and ``close()``."""

    def __init__(self, iterator: Iterator[dict], *, depth: int = 2, transform=None):
        super().__init__(iterator, transform if transform is not None else lambda item: item,
                         depth=depth, name="prefetch-loader")
