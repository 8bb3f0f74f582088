"""The int8 arm as a slice, on the CPU: QAT through the port's CLI into a
checkpoint served by the port's ``ServeEngine(quant_weights=True)``
against sav_tpu's engine on the same weights, the engine's refusals and
HBM-density report against sav_tpu's, and the trainer's "quant"
generator. One QAT step's gradients and the benches:
``test_torch_quant_train.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.interop import flax_from_params
from sav_tpu_torch.models import create_model
from sav_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

# Logits of two f32 engines on the same int8 weights: the attention cores
# (dense on both sides) round apart in the last bit.
SERVE_TOL = 1e-4


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_qat_cli_checkpoint_serves_int8_like_sav_tpus_engine(tmp_path):
    """``python -m sav_tpu_torch.train --quant int8`` trains the small DeiT of
    the ``elastic_smoke`` preset (2 blocks of 64) at 32² three steps into a
    checkpoint; the port's engine serves it with int8 weights
    (``startup_report["quant"]``, dtype ``int8``) and agrees with sav_tpu's
    ``ServeEngine(quant_weights=True)`` given the same weights through
    interop, logit for logit."""
    from sav_tpu.serve.engine import ServeConfig as JaxServeConfig
    from sav_tpu.serve.engine import ServeEngine as JaxServeEngine
    from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine
    from sav_tpu_torch.train import Checkpointer, main

    ckpt = str(tmp_path / "ckpt")
    final = main(["--synth-data", "--device", "cpu", "--preset", "elastic_smoke", "--steps",
                  "3", "--quant", "int8", "-c", ckpt, "--checkpoint-every-steps", "3",
                  # A learning rate that moves the zero-init head off 0 in 3 steps.
                  "--learning-rate", "0.05"])
    assert final["step"] == 3 and np.isfinite(final["loss"])
    raw = Checkpointer(ckpt, read_only=True).restore_raw()
    assert raw["step"] == 3 and "quant" in raw["generators"]
    params = flax_from_params(raw["params"], "ViT")["params"]

    images = _images(4)
    config = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                  compute_dtype="float32", buckets=[1, 2], deadline_ms=2000.0,
                  quant_weights=True, attention_backend="xla",
                  model_overrides=dict(num_layers=2, embed_dim=64, num_heads=4))
    engine = ServeEngine(ServeConfig(checkpoint_dir=ckpt, device="cpu", **config))
    report = engine.startup_report
    assert report["dtype"] == "int8" and report["quant"]["weights_dtype"] == "int8"
    assert tq.is_quantized_template(engine.model.state_dict())
    with engine:
        ours = np.stack([engine.submit(img).result(timeout=60) for img in images])
    assert engine.stats()["quant"] == "int8"
    theirs_engine = JaxServeEngine(JaxServeConfig(**config), params=params)
    with theirs_engine:
        theirs = np.stack([np.asarray(theirs_engine.submit(img).result(timeout=60))
                           for img in images])
    theirs_engine.stop()
    assert theirs_engine.startup_report["quant"] == report["quant"]
    assert np.abs(theirs).max() > 0.1
    np.testing.assert_allclose(ours, theirs, atol=SERVE_TOL, rtol=SERVE_TOL)


def test_engine_refuses_a_passed_model_and_a_quantized_tree():
    from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine

    config = ServeConfig(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                         compute_dtype="float32", buckets=[1], quant_weights=True,
                         model_overrides={"num_layers": 1}, device="cpu")
    with pytest.raises(ValueError, match="quant_weights"):
        ServeEngine(config, model=create_model("vit_ti_patch16", num_classes=10, image_size=32,
                                               num_layers=1))
    served = create_model("vit_ti_patch16", num_classes=10, image_size=32, num_layers=1,
                          quant="int8_serve")
    tree = flax_from_params(served.state_dict(), "ViT")
    with pytest.raises(ValueError, match="already"):
        ServeEngine(config, params=tree)


def test_full_depth_quant_report_matches_sav_tpus():
    """``startup_report["quant"]`` of ViT-Ti/16 at full depth, from the
    engine's own quantization step and with no forward pass, against
    sav_tpu's engine's on the same float weights: the same keys and bytes,
    and the density gate (<= 0.6) met."""
    from sav_tpu.serve.engine import ServeEngine as JaxServeEngine
    from sav_tpu_torch.serve.engine import ServeConfig, ServeEngine

    float_model = create_model("vit_ti_patch16", num_classes=1000, image_size=64)
    config = ServeConfig(model_name="vit_ti_patch16", image_size=64, device="cpu")
    _, ours = ServeEngine._quantized(types.SimpleNamespace(config=config), float_model)
    params = flax_from_params(float_model.state_dict(), "ViT")["params"]
    stub = types.SimpleNamespace(
        config=types.SimpleNamespace(image_size=64), compute_dtype=jnp.float32,
        model=jax_create_model("vit_ti_patch16", num_classes=1000, dtype=jnp.float32,
                               quant="int8_serve"),
        _blayout=types.SimpleNamespace(param_shardings=lambda template: None))
    _, theirs = JaxServeEngine._quantize_params_tree(stub, params)
    assert ours == theirs
    assert set(ours) == {"weights_dtype", "param_bytes_serving", "param_bytes_bf16_equiv",
                         "param_bytes_ratio"}
    assert ours["param_bytes_ratio"] <= 0.6


def test_trainer_threads_the_quant_generator(tmp_path):
    """``TrainConfig.quant``: the model is built on the int8 arm, every QAT
    layer draws from the trainer's "quant" generator (seeded from
    ``stream_seed(seed, "quant")``), the backward draws move it, and a
    checkpoint carries its state; a float run has no such generator, and a
    passed model on another arm is refused."""
    from sav_tpu_torch.train import TrainConfig, Trainer
    from sav_tpu_torch.train.trainer import stream_seed

    config = TrainConfig(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                         compute_dtype="float32", global_batch_size=4, num_train_images=16,
                         transpose_images=False, quant="int8", seed=3,
                         model_overrides={"num_layers": 1})
    trainer = Trainer(config, device="cpu")
    assert trainer.model.quant == "int8"
    gen = trainer.generators["quant"]
    layers = [m for m in trainer.model.modules() if hasattr(m, "quant_generator")]
    assert layers and all(m.quant_generator is gen for m in layers)
    state = trainer.init_state()
    fresh = gen.get_state()
    assert torch.equal(fresh, torch.Generator().manual_seed(stream_seed(3, "quant")).get_state())
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (4,))}
    state, metrics = trainer.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and not torch.equal(gen.get_state(), fresh)
    assert "quant" in state.state_dict()["generators"]
    float_trainer = Trainer(TrainConfig(**{**config.__dict__, "quant": None}), device="cpu")
    assert "quant" not in float_trainer.generators
    with pytest.raises(ValueError, match="quant"):
        Trainer(config, model=create_model("vit_ti_patch16", num_classes=10, image_size=32,
                                           num_layers=1), device="cpu")
