"""QAT through the port's trainer and the benches, on the CPU: one QAT
step's gradients against sav_tpu's with the same stochastic-rounding
draws, the draws per micro-batch, and both benches' int8 lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.ops import quant as tq
from test_torch_quant import _patch_sav_tpu_draws, _port_fixed_draws

torch.set_num_threads(2)

# One QAT step's gradients, relative to each tensor's largest entry: a
# cotangent code that flips where the two sides' f32 backward rounds apart
# moves a gradient entry by one quantization step of its row.
GRAD_SHARE = 1e-2


def test_one_qat_step_gradients_match_sav_tpus(monkeypatch):
    """The small DeiT's every parameter gradient of one QAT step (Σ logits ·
    w) against sav_tpu's, the stochastic rounding fed the same draws on both
    sides, in f32: within GRAD_SHARE of each tensor's largest entry (the
    two dense attention backwards round apart, and a cotangent code that
    flips moves every gradient upstream of it)."""
    from test_torch_vit import SMALL, small_flax_params

    _patch_sav_tpu_draws(monkeypatch)
    params = small_flax_params()
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((3, 10)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="xla", quant="int8", **SMALL)

    def loss(p):
        return jnp.sum(jax_model.apply({"params": p}, x, is_training=False) * w)

    want = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, backend="xla",
                         quant="int8", **SMALL)
    model.load_state_dict(params_from_flax(params), strict=True)
    # Per block the attention (QKV and merge) and the two FF layers; the head.
    assert tq.set_quant_generator(model, _port_fixed_draws) == 2 * 3 + 1
    (model.eval()(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    worst = 0.0
    for name, param in model.named_parameters():
        got, ref = param.grad.numpy(), want[name].numpy()
        share = np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-12)
        assert share <= GRAD_SHARE, (name, share)
        worst = max(worst, share)
    print(f"{len(want)} gradients, largest difference {worst:.3e} of the tensor's largest entry")


def test_accumulation_draws_per_micro_batch():
    """With ``grad_accum_steps`` = 2 every micro-batch's backward rounds with
    draws of its own: a step draws twice what a step of one batch does."""
    from sav_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(1)
    batch = {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (4,))}
    draws = {}
    for accum in (1, 2):
        config = TrainConfig(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                             compute_dtype="float32", global_batch_size=4,
                             num_train_images=16, transpose_images=False, quant="int8",
                             grad_accum_steps=accum, model_overrides={"num_layers": 1})
        trainer = Trainer(config, device="cpu")
        gen, calls = trainer.generators["quant"], []

        def counting(shape, kind, gen=gen, calls=calls):
            calls.append(kind)
            return torch.rand(shape, generator=gen)

        tq.set_quant_generator(trainer.model, counting)
        trainer.train_step(trainer.init_state(), batch)
        draws[accum] = len(calls)
    # Per micro-batch, each dot draws for dx and dw: the QKV per slice.
    assert draws[1] == 2 * (3 + 1 + 2 + 1) and draws[2] == 2 * draws[1]


def test_the_benches_stamp_the_int8_arm_on_the_cpu():
    """``python -m sav_tpu_torch.serve.bench --quant-weights`` and
    ``python -m sav_tpu_torch.train.bench --quant int8`` at a toy size on
    the CPU: each line says ``"quant": "int8"`` (the float lines ``null``),
    the serve line carries ``startup_report["quant"]``, the train line the
    int8 peak and the share of the step's FLOPs in quantized dots."""
    import json

    from sav_tpu_torch.serve import bench as serve_bench
    from sav_tpu_torch.train import bench as train_bench

    overrides = json.dumps({"num_layers": 1})
    common = ["--model", "vit_ti_patch16", "--num-classes", "10", "--image-size", "32",
              "--model-overrides", overrides, "--device", "cpu", "--max-batch", "2",
              "--requests", "4", "--deadline-ms", "5000"]
    lines = {arm: serve_bench.run(serve_bench.parser().parse_args(common + extra))
             for arm, extra in (("int8", ["--quant-weights"]), ("float", []))}
    assert lines["int8"]["quant"] == "int8" and lines["float"]["quant"] is None
    assert lines["int8"]["outcome"] == "ok" and "int8 weights" in lines["int8"]["metric"]
    assert lines["int8"]["startup"]["quant"]["weights_dtype"] == "int8"
    assert "quant" not in lines["float"]["startup"]
    line = train_bench.main(["--model", "vit_ti_patch16", "--batch-size", "2", "--steps", "1",
                             "--reps", "1", "--image-size", "32", "--num-classes", "10",
                             "--model-overrides", overrides, "--device", "cpu", "--quant",
                             "int8"])
    assert line["quant"] == "int8" and line["outcome"] == "ok"
    assert line["peak_source"] == "cpu-fake" and 0.5 < line["int8_flops_share"] < 1.0
