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


NO_COST = [
    ("tnt_s_patch16", {"num_layers": 1, "embed_dim": 32, "inner_ch": 12, "num_heads": 2,
                       "inner_num_heads": 2}, "TNT"),
    ("mixer_s_patch16", {"num_layers": 1, "embed_dim": 32, "tokens_hidden_ch": 8,
                         "channels_hidden_ch": 64}, "MLPMixer"),
    ("cvt-13", {"embed_dims": [16, 32, 32], "num_layers": [1, 1, 1], "num_heads": [1, 1, 2]},
     "CvT"),
]


@pytest.mark.parametrize("model,overrides,family", NO_COST)
def test_bench_prints_its_line_for_a_family_without_an_analytic_cost(capsys, model, overrides,
                                                                    family):
    """The cost model refuses TNT, MLP-Mixer, CvT and CeiT (it would count
    their step wrong); the bench decides that before its windows and still
    prints its one line, without an MFU and saying why."""
    result = bench.main(["--device", "cpu", "--model", model, "--image-size", "32",
                         "--num-classes", "10", "--batch-size", "2", "--steps", "1",
                         "--reps", "1", "--model-overrides", json.dumps(overrides)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result)) and KEYS <= set(line)
    assert line["outcome"] == "ok" and line["value"] > 0
    assert line["mfu"] is None and line["step_flops"] is None
    assert line["cost_source"].startswith(f"none: no analytic step cost for {family}")
    assert "A10" in line["cost_source"]
