"""The port's TFRecord reader and writer (sav_tpu_torch.data.tfrecord),
without TensorFlow, against TensorFlow's own and sav_tpu's
``_tfrecord_source``, on the CPU: shards TF writes read back through the
port with the same bytes and labels; the port's shards read by
``tf.data.TFRecordDataset`` and ``parse_single_example``; a corrupted
checksum refused; the carve-out, skip/take and label shift of
``_tfrecord_source``."""

import numpy as np
import pytest

from sav_tpu_torch.data import tfrecord

tf = pytest.importorskip("tensorflow")


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    images = [bytes(rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8))
              for _ in range(n)]
    return images, rng.integers(0, 1000, n)


def _tf_write(path, images, labels):
    with tf.io.TFRecordWriter(path) as writer:
        for image, label in zip(images, labels):
            example = tf.train.Example(features=tf.train.Features(feature={
                "image/encoded": tf.train.Feature(bytes_list=tf.train.BytesList(value=[image])),
                "image/class/label": tf.train.Feature(
                    int64_list=tf.train.Int64List(value=[int(label)])),
                "image/format": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"JPEG"])),
            }))
            writer.write(example.SerializeToString())


def test_crc32c_known_value_and_plain_version():
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    data = bytes(np.random.default_rng(1).integers(0, 256, 1031, dtype=np.uint8))
    for n in (0, 1, 7, 8, 9, 1031):
        assert tfrecord.crc32c(data[:n]) == tfrecord.crc32c(data[:n], native=False)


def test_tf_written_shards_read_through_the_port(tmp_path):
    images, labels = _examples(9)
    path = str(tmp_path / "train-00000-of-00001")
    _tf_write(path, images, labels)
    source = tfrecord.TFRecordSource("TRAIN", str(tmp_path), 0, 9, custom_size=True)
    assert len(source) == 9
    for i in range(9):
        assert source[i] == (images[i], labels[i])
        assert source.read(i) == next(iter(
            tf.data.TFRecordDataset(path).skip(i).take(1))).numpy()


def test_port_written_shards_read_by_tf(tmp_path):
    images, labels = _examples(7, seed=2)
    labels[3] = -5  # a negative int64 round-trips too
    path = str(tmp_path / "validation-00000-of-00001")
    tfrecord.write_tfrecord_examples(path, images, labels)
    features = {"image/encoded": tf.io.FixedLenFeature([], tf.string),
                "image/class/label": tf.io.FixedLenFeature([], tf.int64)}
    got = [tf.io.parse_single_example(r, features)
           for r in tf.data.TFRecordDataset(path)]
    assert [g["image/encoded"].numpy() for g in got] == images
    assert [int(g["image/class/label"]) for g in got] == list(labels)
    assert [tfrecord.parse_example(r.numpy()) for r in tf.data.TFRecordDataset(path)] == [
        (image, int(label)) for image, label in zip(images, labels)]


@pytest.mark.parametrize("where", ["data", "length"])
def test_a_corrupted_checksum_is_refused(tmp_path, where):
    images, labels = _examples(3, seed=3)
    path = tmp_path / "train-00000-of-00001"
    tfrecord.write_tfrecord_examples(str(path), images, labels)
    raw = bytearray(path.read_bytes())
    raw[20 if where == "data" else 9] ^= 0x10  # a payload byte, or the length's CRC
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupted TFRecord"):
        source = tfrecord.TFRecordSource("TRAIN", str(tmp_path), 0, 3, custom_size=True)
        source[0]


def test_a_dir_without_records_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tfrecord.TFRecordSource("TEST", str(tmp_path), 0, 1)


@pytest.mark.parametrize("split,custom,start,end", [
    ("TRAIN", False, 0, 6), ("TRAIN", False, 2, 5), ("VALID", False, 1, 4),
    ("TEST", False, 0, 5), ("TRAIN", True, 3, 11), ("TEST", True, 0, 4),
])
def test_carve_out_skip_take_and_label_shift_match_sav_tpu(tmp_path, monkeypatch, split,
                                                           custom, start, end):
    """Three train shards of 5 and one validation shard, read by the port and
    by sav_tpu's ``_tfrecord_source`` with the VALID carve-out moved from
    10,000 to 4 records (the port's constant patched; sav_tpu's literal
    through ``Dataset.skip``)."""
    from sav_tpu.data import pipeline as jax_pipeline

    from sav_tpu_torch.data.pipeline import Split

    images, labels = _examples(20, seed=4)
    for shard in range(3):
        _tf_write(str(tmp_path / f"train-{shard:05d}-of-00003"), images[5 * shard: 5 * shard + 5],
                  labels[5 * shard: 5 * shard + 5])
    tfrecord.write_tfrecord_examples(str(tmp_path / "validation-00000-of-00001"), images[15:],
                                     labels[15:])
    monkeypatch.setattr(tfrecord, "VALID_CARVE_OUT", 4)
    real_skip = tf.data.Dataset.skip

    def skip(ds, count):  # sav_tpu's literal 10,000 → 4
        return real_skip(ds, count - 10_000 + 4 if count >= 10_000 else count)

    monkeypatch.setattr(tf.data.Dataset, "skip", skip)
    want = [(ex["image_bytes"], int(ex["label"])) for ex in jax_pipeline._tfrecord_source(
        getattr(jax_pipeline.Split, split), str(tmp_path), start, end,
        custom_size=custom).as_numpy_iterator()]
    source = tfrecord.TFRecordSource(Split[split].name, str(tmp_path), start, end,
                                     custom_size=custom)
    assert [source[i] for i in range(len(source))] == want
    assert len(want) == end - start
