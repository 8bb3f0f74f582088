"""The small MoE ViT against sav_tpu's: logits on fused and xla, and four
Trainer steps over two micro-batches (the helpers are in test_torch_moe.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.models.layers import MoEFFBlock

from test_torch_moe import SMALL, TOL, small_flax_params, small_port_model

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_small_moe_vit_logits_match_sav_tpu(backend):
    x = np.random.default_rng(10).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend=backend, **SMALL)
    want = np.asarray(jax_model.apply({"params": small_flax_params()}, x, is_training=False))
    model = small_port_model(backend=backend).eval()
    assert isinstance(model.encoder.blocks[1].ff, MoEFFBlock)
    assert not isinstance(model.encoder.blocks[0].ff, MoEFFBlock)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_four_moe_train_steps_match_sav_tpu_with_accumulation():
    """The MoE slice as a whole: 4 f32 steps of the small MoE ViT over 2
    micro-batches of 8 through sav_tpu's Trainer and the port's (see
    tests/test_torch_train.py): loss, grad norm, lr and the aux_loss
    metric (the sown balance and z-losses, averaged over the micro-batches;
    1e-5 relative), every parameter and the eval sums."""
    from test_torch_train import _four_steps_against_sav_tpu

    history = _four_steps_against_sav_tpu(
        "vit_ti_patch16", SMALL, small_flax_params(), grad_accum_steps=2, aux_tol=1e-5)
    aux = [r["aux_loss"] for r in history]
    assert min(aux) > 1.0 and len(set(aux)) == 4
