"""A small CvT at 64² against sav_tpu's: eval logits, and train-mode gradients
and running statistics (the helpers are in test_torch_cvt.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu_torch.interop import params_from_flax

from test_torch_ceit import TOL, assert_grad_close
from test_torch_cvt import IMAGE, jax_small_cvt, small_port_model, variables

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_small_cvt_eval_logits_match_sav_tpu(variables, backend):
    x = np.random.default_rng(6).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_small_cvt(backend)
    ref = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x, is_training=False))(variables, x))
    model = small_port_model(variables, backend=backend).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 0.1  # the drawn head makes the check non-vacuous
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_small_cvt_train_mode_grads_and_batch_stats_match_sav_tpu(variables, backend):
    """Train mode at each kernel backend (their plain versions here, the
    Pallas kernels in interpret mode there): logits from batch statistics,
    every parameter's gradient of Σ logits², and the updated running
    statistics."""
    x = np.random.default_rng(7).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_small_cvt(backend)

    def loss(params):
        logits, new = jax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      x, is_training=True, mutable=["batch_stats"])
        return jnp.sum(logits ** 2), (logits, new["batch_stats"])

    (_, (ref, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = small_port_model(variables, backend=backend).train()
    logits = model(torch.from_numpy(x))
    (logits ** 2).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), **TOL)
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    assert float(got["stages.0.blocks.0.attn.to_k.depthwise.weight"].abs().max()) > 1e-4
    for name, grad in got.items():
        assert_grad_close(grad.numpy(), want[name].numpy(), name)
    want_stats = params_from_flax({"params": variables["params"],
                                   "batch_stats": jax.tree.map(np.asarray, new_stats)})
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
