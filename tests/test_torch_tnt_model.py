"""A small TNT at 32² against sav_tpu's on fused, pallas and xla: logits and
every gradient (the helpers are in test_torch_tnt.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu_torch.interop import params_from_flax

from test_torch_tnt import IMAGE, TOL, assert_grad_close, inner, jax_small_tnt, small_port_model

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_small_tnt_logits_and_grads_match_sav_tpu(inner, backend):
    """Logits and every gradient of Σ logits² at each backend, at inner head
    dims 6 and 10 (the module fixture): sav_tpu's Pallas kernels in
    interpret mode or its dense path; the port's plain versions on the
    padded head dim or its dense path."""
    inner_dim, params = inner
    x = np.random.default_rng(8).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_small_tnt(inner_dim, backend)

    def loss(p):
        logits = jax_model.apply({"params": p}, x, is_training=False)
        return jnp.sum(logits ** 2), logits

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = small_port_model(params, inner_dim, backend=backend)
    logits = model(torch.from_numpy(x))
    (logits ** 2).sum().backward()
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), **TOL)
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in ("blocks.0.inner_attn.to_qkv", "pixel_embed.proj.weight",
                 "inner_pos_embed.pos_embed"):
        assert float(got[name].abs().max()) > 1e-5, name
    for name, grad in got.items():
        assert_grad_close(grad.numpy(), want[name].numpy(), name)
