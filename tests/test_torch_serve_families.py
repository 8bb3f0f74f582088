"""The serving engine on the CPU with a tiny CaiT and a small BoTNet against
sav_tpu's (the helpers are in test_torch_serve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.serve.engine import build_infer_fn as jax_build_infer_fn
from sav_tpu_torch.serve.engine import ServeEngine

from test_torch_vit import small_flax_params
from test_torch_serve import TOL, _config, _images

torch.set_num_threads(2)


def test_engine_serves_a_tiny_cait_on_the_cpu():
    """A CaiT (talking-heads trunk, class attention) through the same engine:
    its logits match sav_tpu's build_infer_fn on the same flax tree."""
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    params = small_flax_params(seed=2)
    images = _images(5, seed=3)
    jax_model = jax_create_model(
        "cait_xxs_24", num_classes=10, dtype=jnp.float32, backend="fused", **CAIT_SMALL
    )
    infer = jax.jit(jax_build_infer_fn(jax_model, jnp.float32))
    ref = np.asarray(infer(params, {}, {"images": images, "valid": np.ones(5, np.float32)}))
    # A generous deadline, as for the BoTNet below: a CaiT step on a loaded
    # CPU can take a sixth of a second, and admission must not shed here.
    config = _config(model_name="cait_xxs_24", model_overrides=CAIT_SMALL, max_batch=4,
                     deadline_ms=30_000.0)
    with ServeEngine(config, params=params) as engine:
        out = [f.result(timeout=60) for f in [engine.submit(image) for image in images]]
    assert engine.stats()["ledger"]["requests"] == 5
    assert engine.startup_report["model"] == "cait_xxs_24"
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(np.stack(out), ref, atol=TOL, rtol=TOL)


def test_engine_serves_a_small_botnet_from_params_and_batch_stats():
    """A BoTNet (BatchNorm, SAME padding, squeeze-excite, the relative-
    position attention) served from a flax ``params`` + ``batch_stats``
    tree: in eval mode, on the running statistics, its logits match sav_tpu's
    build_infer_fn (``model.apply(..., is_training=False)``) on the same
    tree."""
    from test_torch_botnet import IMAGE, jax_small_botnet, small_flax_variables
    from test_torch_botnet import SMALL as BOTNET_SMALL

    variables = small_flax_variables(seed=4)
    images = np.random.default_rng(5).integers(0, 256, (5, IMAGE, IMAGE, 3), dtype=np.uint8)
    infer = jax.jit(jax_build_infer_fn(jax_small_botnet("pallas"), jnp.float32))
    ref = np.asarray(infer(variables["params"], variables["batch_stats"],
                           {"images": images, "valid": np.ones(5, np.float32)}))
    # A generous deadline: a BoTNet step on a loaded CPU can take a fifth of
    # a second, and admission must not shed here.
    config = _config(model_name="botnet_t3", model_overrides=BOTNET_SMALL, image_size=IMAGE,
                     max_batch=4, deadline_ms=30_000.0)
    with ServeEngine(config, params=variables) as engine:
        assert not engine.model.training
        out = [f.result(timeout=60) for f in [engine.submit(image) for image in images]]
    assert engine.stats()["ledger"]["requests"] == 5
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(np.stack(out), ref, atol=TOL, rtol=TOL)
