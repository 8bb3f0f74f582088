"""Each ``pos_embed`` mode of the ViT on fused, pallas and xla against
sav_tpu's (the helpers are in test_torch_rotary.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model

from test_torch_rotary import MODES, SMALL, TOL, small_flax_params, small_port_model

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_vit_pos_embed_modes_match_sav_tpu(mode, backend):
    """Each position mode of the small ViT, logits on each backend (the
    kernels' plain versions here, the Pallas kernels in interpret mode
    there); the modes give different logits."""
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend=backend, pos_embed=mode, **SMALL)
    want = np.asarray(jax_model.apply({"params": small_flax_params(mode)}, x, is_training=False))
    with torch.no_grad():
        got = small_port_model(mode, backend=backend)(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
