"""The port's native loader (sav_tpu_torch.data.native_loader, built from
sav_tpu_torch/native/ with g++ at first use) against sav_tpu's, on the CPU.

Every entry point, the port's native library and its numpy plain version,
against sav_tpu's native library and its numpy fallback: exactly equal.
The bf16 cast is compared bit for bit (sav_tpu returns ml_dtypes arrays,
the port torch.bfloat16 tensors over the same uint16 bits). The port's
normalize multiplies by the reciprocal natively, as sav_tpu's library
does, and divides in numpy, as sav_tpu's fallback does: each pair is held
against its own counterpart. sav_tpu's library is compiled for the module
(:func:`sav_tpu_native_library`), also used by ``test_torch_records.py``.
"""

import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sav_tpu.data import native_loader as jax_nl
from sav_tpu_torch.data import _native_build, mix
from sav_tpu_torch.data import native_loader as nl
from sav_tpu_torch.data.augment_spec import parse_augment_spec
from sav_tpu_torch.data.constants import MEAN_RGB, STDDEV_RGB


NATIVE = Path(__file__).resolve().parent.parent / "native"


@pytest.fixture(scope="module", autouse=True)
def sav_tpu_native_library(tmp_path_factory):
    """sav_tpu's own native library, compiled for this module from
    ``native/loader.cc`` and ``records.cc`` with ``native/Makefile``'s
    flags into a directory of the test's own, and ``sav_tpu``'s loader
    pointed at it: the library ``make -C native`` leaves in ``native/``
    (which only sav_tpu's own test builds) is not waited for, so the
    outcome does not hang on which module a test worker reaches first."""
    flags = re.search(r"^CXXFLAGS \?= (.*)$", (NATIVE / "Makefile").read_text(), re.M)
    library = tmp_path_factory.mktemp("sav_tpu_native") / "libsavtpu_loader.so"
    subprocess.run([os.environ.get("CXX", "g++"), *flags.group(1).split(), "-o", str(library),
                    str(NATIVE / "loader.cc"), str(NATIVE / "records.cc")],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_nl, "_LIB_PATH", str(library))
        patch.setattr(jax_nl, "_lib", None)
        yield library


@pytest.fixture
def sav_numpy(monkeypatch):
    """sav_tpu's numpy fallbacks: its library made to look absent."""
    monkeypatch.setattr(jax_nl, "_load", lambda: None)


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _images(seed=0, shape=(6, 9, 7, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_the_library_builds_with_the_abi_version():
    assert nl.native_available()
    assert _native_build.library_path().exists()
    assert _native_build.load().sav_loader_abi_version() == _native_build.ABI_VERSION == 1
    assert _native_build.library_path().parent == _native_build.BUILD_DIR


@pytest.mark.parametrize("transpose", [False, True])
def test_normalize_batch(transpose, sav_numpy):
    images = _images()
    want_numpy = jax_nl.normalize_batch(images, MEAN_RGB, STDDEV_RGB, transpose=transpose)
    got_numpy = nl.normalize_batch(images, MEAN_RGB, STDDEV_RGB, transpose=transpose,
                                   native=False)
    np.testing.assert_array_equal(got_numpy, want_numpy)


@pytest.mark.parametrize("transpose", [False, True])
def test_normalize_batch_native(transpose):
    images = _images(1, (5, 8, 6, 3))
    want = jax_nl.normalize_batch(images, MEAN_RGB, STDDEV_RGB, transpose=transpose)
    assert jax_nl.native_available()
    got = nl.normalize_batch(images, MEAN_RGB, STDDEV_RGB, transpose=transpose)
    np.testing.assert_array_equal(got, want)
    assert got.flags.c_contiguous and got.shape == ((8, 6, 3, 5) if transpose else (5, 8, 6, 3))
    scalar = nl.normalize_batch(images, 127.5, 64.0)
    np.testing.assert_array_equal(scalar, jax_nl.normalize_batch(images, 127.5, 64.0))


def test_f32_to_bf16_bits(sav_numpy):
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.standard_normal(997).astype(np.float32) * 100,
                        np.float32([0.0, -0.0, 1e-38, 3.4e38, -3.4e38, np.inf, -np.inf,
                                    1.00390625, 1.01171875])]).astype(np.float32)
    x = x.reshape(-1, 1)
    want = _bits(jax_nl.f32_to_bf16(x))
    got_native = nl.f32_to_bf16(x)
    got_plain = nl.f32_to_bf16(x, native=False)
    assert got_native.dtype == torch.bfloat16 and tuple(got_native.shape) == x.shape
    np.testing.assert_array_equal(_bits(got_native), want)
    np.testing.assert_array_equal(_bits(got_plain), want)


def test_f32_to_bf16_keeps_nan_quiet():
    x = np.array([np.nan, -np.nan, np.float32(np.nan) * 0], np.float32)
    for got in (nl.f32_to_bf16(x), nl.f32_to_bf16(x, native=False)):
        assert torch.isnan(got.float()).all()
        np.testing.assert_array_equal(_bits(got), _bits(jax_nl.f32_to_bf16(x)))


@pytest.mark.parametrize("flip", [None, "mask"])
def test_passthrough_batch_u8(flip, sav_numpy):
    images = _images(3)
    mask = None if flip is None else np.array([1, 0, 1, 1, 0, 0], bool)
    want = jax_nl.passthrough_batch_u8(images, flip=mask)
    for native in (True, False):
        got = nl.passthrough_batch_u8(images, flip=mask, native=native)
        np.testing.assert_array_equal(got, want)
        assert got is not images and got.flags.c_contiguous


def test_gather_batch(sav_numpy):
    pool = _images(4, (10, 4, 4, 3))
    idx = np.array([9, 0, 3, 3, 7])
    want = jax_nl.gather_batch(pool, idx)
    for native in (True, False):
        np.testing.assert_array_equal(nl.gather_batch(pool, idx, native=native), want)
        with pytest.raises(IndexError):
            nl.gather_batch(pool, np.array([0, -1]), native=native)
        with pytest.raises(IndexError):
            nl.gather_batch(pool, np.array([10]), native=native)


def test_transpose_nhwc_to_hwcn(sav_numpy):
    x = np.random.default_rng(5).standard_normal((7, 5, 4, 3)).astype(np.float32)
    want = jax_nl.transpose_nhwc_to_hwcn(x)
    for native in (True, False):
        got = nl.transpose_nhwc_to_hwcn(x, native=native)
        np.testing.assert_array_equal(got, want)
        assert got.flags.c_contiguous


def test_the_native_entry_points_match_sav_tpus_library():
    """The port's library against sav_tpu's own, on shapes whose HWCN
    writes span several of the port's blocks."""
    assert jax_nl.native_available()
    images = _images(6, (33, 11, 13, 3))
    mask = np.arange(33) % 3 == 0
    np.testing.assert_array_equal(nl.passthrough_batch_u8(images, flip=mask),
                                  jax_nl.passthrough_batch_u8(images, flip=mask))
    x = np.random.default_rng(7).standard_normal((33, 11, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(nl.transpose_nhwc_to_hwcn(x), jax_nl.transpose_nhwc_to_hwcn(x))
    np.testing.assert_array_equal(_bits(nl.f32_to_bf16(x)), _bits(jax_nl.f32_to_bf16(x)))
    np.testing.assert_array_equal(nl.gather_batch(images, np.arange(33)[::-1]),
                                  jax_nl.gather_batch(images, np.arange(33)[::-1]))


@pytest.mark.parametrize("augment", ["cutmix_mixup", "mixup", "cutmix", "none"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bfloat16", [False, True])
def test_mix_normalize_batch_native_equals_plain(augment, transpose, bfloat16):
    """The fused batch stage (mix, normalize, layout, cast) against its plain
    version, bit for bit."""
    images = _images(8, (10, 12, 9, 3))
    plan = mix.mix_plan(10, 12, 9, parse_augment_spec(augment),
                        rng=np.random.default_rng(9))
    kwargs = dict(plan=plan, transpose=transpose, bfloat16=bfloat16)
    got = nl.mix_normalize_batch(images, MEAN_RGB, STDDEV_RGB, **kwargs)
    want = nl.mix_normalize_batch(images, MEAN_RGB, STDDEV_RGB, native=False, **kwargs)
    if bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # Without a plan: sav_tpu's pipeline normalize, (x - mean) / std.
    if plan is None:
        ref = (images.astype(np.float32) - np.float32(MEAN_RGB)) / np.float32(STDDEV_RGB)
        ref = np.transpose(ref, (1, 2, 3, 0)) if transpose else ref
        np.testing.assert_array_equal(_bits(got) if bfloat16 else got,
                                      _bits(nl.f32_to_bf16(ref)) if bfloat16 else ref)


def test_prefetch_loader_order_errors_and_close():
    loader = nl.PrefetchLoader(iter(range(5)), depth=2, transform=lambda x: x * 10)
    assert list(loader) == [0, 10, 20, 30, 40]
    with pytest.raises(StopIteration):
        next(loader)

    def failing():
        yield 1
        raise RuntimeError("source broke")

    loader = nl.PrefetchLoader(failing())
    assert next(loader) == 1
    with pytest.raises(RuntimeError, match="source broke"):
        next(loader)
    loader = nl.PrefetchLoader(iter(range(100)), depth=1)
    assert next(loader) == 0
    loader.close()
