"""The int8 arm's layers against sav_tpu's, on the CPU: the QAT layer and
the serving layer give the same bits, the stacked QKV block's forward and
gradients, the int8 serving tree through interop both ways, and every
registry name at both arms. Helpers: ``test_torch_quant.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sav_tpu_torch.ops.quant as tq
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model
from test_torch_quant import (
    TOL,
    _patch_sav_tpu_draws,
    _port_fixed_draws,
    _serving_variables,
    _vit_case,
)

torch.set_num_threads(2)


def test_qat_forward_is_bit_identical_to_serve_forward():
    """sav_tpu's parity gate (tests/test_quant.py), carried over in f32:
    the QAT layer (the weight quantized on the fly) and the serving one (the
    weight quantized by quantize_params) give the same bits, for the
    ``Dense`` twin, a raw projection and the stacked QKV."""
    rng = np.random.default_rng(5)
    qat = tq.QuantDense(16, 8)
    torch.nn.init.normal_(qat.weight, generator=torch.Generator().manual_seed(0))
    torch.nn.init.normal_(qat.bias, generator=torch.Generator().manual_seed(1))
    serve = tq.QuantDenseServe(16, 8)
    serve.load_state_dict(tq.quantize_params(qat.state_dict(), serve.state_dict()))
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(qat(x).numpy(), serve(x).numpy())
    from sav_tpu_torch.models.layers import SelfAttentionBlock

    blocks = {q: SelfAttentionBlock(16, 2, quant=q) for q in ("int8", "int8_serve")}
    blocks["int8"].reset_parameters(torch.Generator().manual_seed(2))
    blocks["int8_serve"].load_state_dict(
        tq.quantize_params(blocks["int8"].state_dict(), blocks["int8_serve"].state_dict()))
    tokens = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(blocks["int8"](tokens).numpy(),
                                      blocks["int8_serve"](tokens).numpy())


def test_stacked_qkv_block_matches_sav_tpu_forward_and_gradients(monkeypatch):
    """The stacked QKV as one product forward and per slice backward (each
    slice's own cotangent scale), the merge contracting two axes: the
    block's output and its input and weight gradients against sav_tpu's
    ``SelfAttentionBlock(quant="int8")`` in f32, with the same draws, to
    :data:`TOL`: the attention cores (dense on both sides) round apart in
    the last bit, which moves the merge's row scales by as much, and dx is
    the sum of three slices, which the two sides add in another order."""
    from sav_tpu.models.layers import SelfAttentionBlock as JaxSelfAttention
    from sav_tpu_torch.models.layers import SelfAttentionBlock

    _patch_sav_tpu_draws(monkeypatch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jax_block = JaxSelfAttention(num_heads=2, quant="int8", backend="xla")
    params = jax_block.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), False)["params"]
    y = jax_block.apply({"params": params}, jnp.asarray(x), False)
    g = rng.standard_normal(y.shape).astype(np.float32)

    def f(p, x):
        return (jax_block.apply({"params": p}, x, False) * g).sum()

    dp, dx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    block = SelfAttentionBlock(16, 2, quant="int8", backend="xla")
    with torch.no_grad():
        block.to_qkv.copy_(torch.from_numpy(np.asarray(params["to_qkv"]["kernel"])))
        block.to_out.copy_(torch.from_numpy(np.asarray(params["to_out"]["kernel"])))
    block.quant_generator = _port_fixed_draws
    tx = torch.from_numpy(x).requires_grad_()
    ty = block(tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=TOL, atol=TOL)
    ty.backward(torch.from_numpy(g))
    for got, want in ((tx.grad, dx), (block.to_qkv.grad, dp["to_qkv"]["kernel"]),
                      (block.to_out.grad, dp["to_out"]["kernel"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_interop_round_trips_the_serving_tree():
    """sav_tpu's int8 serving tree → the port's serving state (int8 codes
    transposed for the Dense twins, as is for the raw projections, scales
    beside them) → back, bit for bit."""
    case = _vit_case()
    served = _serving_variables(case)
    state = params_from_flax(served)
    assert state["head.weight"].dtype == torch.int8
    assert state["encoder.blocks.0.attn.to_qkv"].dtype == torch.int8
    assert state["encoder.blocks.0.attn.to_qkv_scale"].shape == (3, 2, 32)
    back = flax_from_params(state, "ViT")["params"]
    flat = jax.tree_util.tree_leaves_with_path(served["params"])
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tq.is_quantized_template(state)
    assert not tq.is_quantized_template(params_from_flax(case.variables))


def test_registry_builds_every_name_at_both_arms(monkeypatch):
    """Every registry name sav_tpu builds with ``quant`` builds here (on the
    meta device, where nothing is drawn) with int8 codes and scales at
    ``int8_serve``; for one name of each family the codes have the float
    tree's shapes and ``int8`` keeps the float tree; the MoE ViT keeps
    float experts."""
    from sav_tpu.models import registry as jax_registry
    from sav_tpu_torch.models import model_names, registry
    from sav_tpu_torch.models.layers import MoEFFBlock

    assert set(model_names()) == set(jax_registry.model_names())
    monkeypatch.setattr(registry, "_build", lambda cls, n, kwargs, seed: cls(n, **kwargs))
    # The QAT tree is the float one: held for one name of each family.
    firsts = ("deit_s_patch16", "cait_xxs_24", "botnet_t3", "tnt_s_patch16", "ceit_s",
              "cvt-13", "mixer_s_patch16")
    with torch.device("meta"):
        for name in model_names():
            serve = create_model(name, quant="int8_serve").state_dict()
            codes = tq.quantized_keys(serve)
            assert "head.weight" in codes, name
            if name not in firsts:
                continue
            shapes = {k: v.shape for k, v in create_model(name).state_dict().items()}
            qat = create_model(name, quant="int8").state_dict()
            assert {k: v.shape for k, v in qat.items()} == shapes, name
            assert all(shapes[key] == serve[key].shape for key in codes), name
        moe = create_model("vit_moe_s_patch16_e8", quant="int8_serve")
        blocks = [m for m in moe.modules() if isinstance(m, MoEFFBlock)]
        assert blocks and all(t.is_floating_point() for m in blocks
                              for t in m.state_dict().values())
    with pytest.raises(ValueError, match="unknown quant mode"):
        create_model("deit_s_patch16", quant="int4", num_layers=1)
