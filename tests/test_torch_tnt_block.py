"""One TNT EncoderBlock at inner head dims 6 and 10 against sav_tpu's, output
and gradients (the helpers are in test_torch_tnt.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models.tnt import EncoderBlock as JaxEncoderBlock
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models.tnt import EncoderBlock

from test_torch_tnt import INNER_DIMS, assert_grad_close, init_flax, sub_state

torch.set_num_threads(2)


@pytest.mark.parametrize("inner_dim", INNER_DIMS)
def test_encoder_block_matches_sav_tpu_with_gradients(inner_dim):
    """One block at the fused backend (sav_tpu's Pallas kernels in interpret
    mode, the port's plain versions on the zero-padded head dim): both
    streams' outputs and every gradient of Σ pixel² + Σ patch²."""
    rng = np.random.default_rng(2)
    inner_ch = 4 * inner_dim
    pixel = rng.standard_normal((2 * 4, 16, inner_ch)).astype(np.float32)
    patch = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jax_block = JaxEncoderBlock(embed_dim=32, num_heads=2, inner_num_heads=4, backend="fused")
    params = init_flax(jax_block, jnp.asarray(pixel), jnp.asarray(patch),
                       is_training=False)["params"]

    def jax_loss(p, pixel, patch):
        a, b = jax_block.apply({"params": p}, pixel, patch, is_training=False)
        return jnp.sum(a ** 2) + jnp.sum(b ** 2), (a, b)

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(pixel), jnp.asarray(patch))
    block = EncoderBlock(32, inner_ch, 16, 2, 4, backend="fused")
    block.load_state_dict(sub_state(params_from_flax({"PixelEmbedBlock_0": {},
                                                      "block_0": params}), "blocks.0."),
                          strict=True)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (pixel, patch)]
    got = block(*inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    (got[0] ** 2).sum().add((got[1] ** 2).sum()).backward()
    for t, g, name in zip(inputs, grads[1:], ("pixel", "patch")):
        assert_grad_close(t.grad.numpy(), np.asarray(g), name)
    want_grads = sub_state(params_from_flax({"PixelEmbedBlock_0": {},
                                             "block_0": jax.tree.map(np.asarray, grads[0])}),
                           "blocks.0.")
    for name, p in block.named_parameters():
        assert_grad_close(p.grad.numpy(), want_grads[name].numpy(), name)
