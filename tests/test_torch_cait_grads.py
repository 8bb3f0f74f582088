"""A small CaiT's parameter gradients against sav_tpu's at backends fused and
xla (the helpers are in test_torch_cait.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu_torch.interop import params_from_flax

from test_torch_cait import TOL, _jax_model, small_flax_params, small_port_model

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_small_cait_gradients_match_sav_tpu(backend):
    """Every parameter's gradient of Σ logits², the trunk's talking-heads
    kernels and the class attention's fused kernel in both directions."""
    params = small_flax_params(seed=1)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jax_model = _jax_model(backend)

    def loss(p):
        return jnp.sum(jax_model.apply({"params": p}, x, is_training=False) ** 2)

    want = params_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    model = small_port_model(params, backend=backend).eval()
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(want)
    assert float(grads["blocks.0.attn.pre_softmax.kernel"].abs().max()) > 1e-3
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), **TOL, err_msg=name)
