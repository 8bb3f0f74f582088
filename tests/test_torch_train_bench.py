"""The port's train bench (``python -m sav_tpu_torch.train.bench``) on the
CPU at a toy size: one parseable JSON line with the keys its readers use,
for the synthetic feed, the host pipeline and the SavRecord feed, and for
every family an analytic MFU."""

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
    assert line["step_ms"] == min(line["window_step_ms"]) and line["warmup_steps"] == 2
    assert line["transfer_bytes_per_batch"] == 4 * 32 * 32 * 3 * image_bytes + 4 * 4
    assert line["capture_s"] == 0.0 and line["captured_launches"] == {}
    assert line["replays"] == 0 and line["replayed_launches"] == {}  # eager on the CPU
    assert len(line["window_step_ms"]) == 2
    assert (line["feeder"] is None) == ("--no-async-feed" in extra)


@pytest.mark.parametrize("feed", ["pipeline", "savrec"])
def test_bench_refuses_the_feeds_it_does_not_carry(capsys, feed, tmp_path):
    """The fed feeds (no longer refused): the line names the feed, the
    feed's own rate and the native loader; its rate is every window's
    images over every window's time, after a warm-up that drains the
    batches in flight (the feeder's depth, the one it places and the
    pipeline's lookahead); the device idle share is null on the CPU, which
    has no device clock."""
    from sav_tpu_torch.data.pipeline import LOOKAHEAD

    result = bench.main(TOY + ["--feed", feed, "--work-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result)) and KEYS <= set(line)
    assert line["outcome"] == "ok" and line["feed"] == feed and line["native_loader"] is True
    assert line["host_feed_img_per_sec"] > 0 and line["value"] > 0
    assert line["metric"].endswith("all of 2x2-step windows)")
    windows = line["window_step_ms"]
    assert line["step_ms"] == pytest.approx(sum(windows) / len(windows), abs=2e-3)
    assert line["value"] == pytest.approx(4e3 / line["step_ms"], rel=1e-3)
    assert line["warmup_steps"] == 2 + 2 + 1 + (LOOKAHEAD + 1 if feed == "pipeline" else 0)
    assert line["device_step_ms"] is None and line["device_idle_share"] is None
    assert ("decoder" in line) == (feed == "pipeline")
    assert line["transfer_bytes_per_batch"] == 4 * 32 * 32 * 3 * 2 + 4 * 4 + (
        4 * 4 + 4 * 4 if feed == "pipeline" else 0)  # the host mixes' labels and ratios
    assert (tmp_path / "bench.savrec").exists() == (feed == "savrec")


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
    """TNT, MLP-Mixer and CvT, which sav_tpu's count would count wrong, have
    their own count (no longer refused): the line carries an MFU and the
    family's step FLOPs."""
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.obs import costs

    result = bench.main(["--device", "cpu", "--model", model, "--image-size", "32",
                         "--num-classes", "10", "--batch-size", "2", "--steps", "1",
                         "--reps", "1", "--model-overrides", json.dumps(overrides)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result)) and KEYS <= set(line)
    assert line["outcome"] == "ok" and line["value"] > 0
    net = create_model(model, num_classes=10, image_size=32, **overrides)
    assert type(net).__name__ == family and family in costs.FAMILY_COUNTS
    # An MFU is reported (rounded to 4 places: a toy step on a loaded CPU
    # against the fake peak may round to 0.0).
    assert line["cost_source"] == "analytic" and isinstance(line["mfu"], float)
    assert line["step_flops"] == pytest.approx(
        costs.train_step_cost(net, batch_size=2, image_size=32).flops, rel=1e-12)
