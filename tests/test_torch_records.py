"""SavRecord files in the port (sav_tpu_torch.data.records) against sav_tpu's,
on the CPU: a file written by either package is read by the other, byte for
byte, and the epoch and train iterators give sav_tpu's batches exactly for
the same seed and host shards."""

import numpy as np
import pytest
import torch

from sav_tpu.data import records as jax_records
from sav_tpu_torch.data import records
# sav_tpu's native library, compiled for this module (its reader reaches it).
from test_torch_native_loader import sav_tpu_native_library  # noqa: F401

N, SHAPE = 23, (6, 5, 3)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (N, *SHAPE), dtype=np.uint8),
            rng.integers(-3, 1000, (N,), dtype=np.int32))


@pytest.fixture
def files(tmp_path):
    images, labels = _data()
    ours, theirs = str(tmp_path / "port.savrec"), str(tmp_path / "sav.savrec")
    records.write_savrec(ours, images, labels)
    jax_records.write_savrec(theirs, images, labels)
    return ours, theirs, images, labels


def _as_numpy(batch: dict) -> dict:
    out = {}
    for key, value in batch.items():
        if torch.is_tensor(value):
            value = value.view(torch.int16).numpy().view(np.uint16)
        elif value.dtype.name == "bfloat16":
            value = value.view(np.uint16)
        out[key] = np.asarray(value)
    return out


def test_files_are_byte_equal(files):
    ours, theirs, _, _ = files
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["port", "sav_tpu"])
@pytest.mark.parametrize("native", [True, False])
def test_each_side_reads_the_other(files, writer, native):
    ours, theirs, images, labels = files
    path = ours if writer == "port" else theirs
    idx = np.array([22, 0, 7, 7, 13])
    with records.SavRecDataset(path, native=native) as ds:
        assert len(ds) == N and ds.image_shape == SHAPE and ds.native == native
        got = ds.read_batch(idx)
    np.testing.assert_array_equal(got["images"], images[idx])
    np.testing.assert_array_equal(got["labels"], labels[idx])
    want = jax_records.SavRecDataset(ours if writer == "sav_tpu" else theirs).read_batch(idx)
    for key in ("images", "labels"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("native", [True, False])
def test_bad_files_and_indices_are_refused(tmp_path, files, native):
    ours = files[0]
    with records.SavRecDataset(ours, native=native) as ds:
        with pytest.raises(IndexError):
            ds.read_batch(np.array([N]))
        with pytest.raises(IndexError):
            ds.read_batch(np.array([-1]))
    garbage = tmp_path / "garbage.savrec"
    garbage.write_bytes(b"not a savrec file at all, just bytes" * 3)
    with pytest.raises(ValueError):
        records.SavRecDataset(str(garbage), native=native)
    truncated = tmp_path / "truncated.savrec"
    truncated.write_bytes(open(ours, "rb").read()[:-10])
    with pytest.raises(ValueError):
        records.SavRecDataset(str(truncated), native=native)


def test_host_shard_indices_match():
    for n, hosts in ((23, 1), (23, 4), (10, 3)):
        for host in range(hosts):
            np.testing.assert_array_equal(records.host_shard_indices(n, host, hosts),
                                          jax_records.host_shard_indices(n, host, hosts))
    with pytest.raises(ValueError):
        records.host_shard_indices(10, 3, 3)


@pytest.mark.parametrize("host_id,host_count", [(0, 1), (1, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_iterator_gives_sav_tpus_batches(files, host_id, host_count, shuffle):
    ours, theirs, _, _ = files
    kwargs = dict(batch_size=4, shuffle=shuffle, seed=11, host_id=host_id,
                  host_count=host_count, num_epochs=3, start_epoch=2)
    got = list(records.savrec_epoch_iterator(records.SavRecDataset(ours), **kwargs))
    want = list(jax_records.savrec_epoch_iterator(jax_records.SavRecDataset(theirs), **kwargs))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for key in ("images", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="no batch"):
        next(records.savrec_epoch_iterator(records.SavRecDataset(ours), batch_size=N + 1))


@pytest.mark.parametrize("normalize,transpose,bfloat16", [
    (True, False, False), (True, True, False), (True, True, True), (True, False, True),
    (False, False, False),
])
def test_train_iterator_gives_sav_tpus_batches(files, normalize, transpose, bfloat16):
    ours, theirs, _, _ = files
    kwargs = dict(batch_size=5, seed=3, normalize=normalize, transpose=transpose,
                  bfloat16=bfloat16, num_epochs=2, host_id=0, host_count=1)
    got = list(records.savrec_train_iterator(records.SavRecDataset(ours), **kwargs))
    want = list(jax_records.savrec_train_iterator(jax_records.SavRecDataset(theirs),
                                                  **kwargs))
    assert len(got) == len(want) == 2 * (N // 5)
    for a, b in zip(got, want):
        if bfloat16 and normalize:
            assert a["images"].dtype == torch.bfloat16
        a, b = _as_numpy(a), _as_numpy(b)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_train_iterator_refuses_a_raw_transpose(files):
    with pytest.raises(ValueError, match="transpose"):
        next(records.savrec_train_iterator(records.SavRecDataset(files[0]), batch_size=4,
                                           normalize=False, transpose=True))
