"""The port's train bench (``python -m sav_tpu_torch.train.bench``) on the
CPU at a toy size: one parseable JSON line with the keys its readers use,
and the feeds it does not carry refused, naming their ROADMAP item."""

import json

import pytest
import torch

from sav_tpu_torch.train import bench

torch.set_num_threads(2)

TOY = ["--device", "cpu", "--model", "vit_ti_patch16", "--image-size", "32",
       "--num-classes", "10", "--batch-size", "4", "--steps", "2", "--reps", "2",
       "--model-overrides", '{"num_layers": 1, "embed_dim": 32, "num_heads": 2, '
       '"patch_shape": [8, 8]}']
KEYS = {"value", "median_img_per_sec", "step_ms", "mfu", "peak_flops", "peak_source",
        "transfer_bytes_per_batch", "capture_s", "captured_launches", "replays",
        "replayed_launches", "platform", "card", "outcome"}


@pytest.mark.parametrize("extra,image_bytes", [
    ([], 2),  # bf16 on the wire
    (["--device-preprocess"], 1),  # uint8: half
    (["--device-preprocess", "--no-async-feed"], 1),
])
def test_bench_prints_one_json_line(capsys, extra, image_bytes):
    result = bench.main(TOY + extra)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert KEYS <= set(line) and line == json.loads(json.dumps(result))
    assert line["outcome"] == "ok" and line["platform"] == "cpu" and line["card"] is None
    assert line["peak_source"] == "cpu-fake" and 0 < line["mfu"]
    assert line["value"] >= line["median_img_per_sec"] > 0
    assert line["transfer_bytes_per_batch"] == 4 * 32 * 32 * 3 * image_bytes + 4 * 4
    assert line["capture_s"] == 0.0 and line["captured_launches"] == {}
    assert line["replays"] == 0 and line["replayed_launches"] == {}  # eager on the CPU
    assert len(line["window_step_ms"]) == 2
    assert (line["feeder"] is None) == ("--no-async-feed" in extra)


@pytest.mark.parametrize("feed", ["pipeline", "savrec"])
def test_bench_refuses_the_feeds_it_does_not_carry(capsys, feed):
    with pytest.raises(SystemExit):
        bench.main(TOY + ["--feed", feed])
    assert "A6" in capsys.readouterr().err
