"""The port's CaiT (sav_tpu_torch.models.cait) against sav_tpu's, on the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs. At init CaiT's LayerScale
(1e-5) scales every residual branch to almost nothing and the head is zero,
so logits and gradients would agree even with a wrong trunk: the tests draw
the head and every LayerScale scale first. Tolerances are
tests/test_models.py's for CaiT: f32 atol 1e-4, rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers.regularization import StochasticDepthBlock as JaxStochasticDepth
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model, model_names
from sav_tpu_torch.models.cait import CaiT
from sav_tpu_torch.models.layers import (
    LayerScaleBlock,
    StochasticDepthBlock,
    set_stochastic_depth_generator,
)

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=5e-3)
# embed 32, 2 talking-heads layers, 2 heads of 16, 1 class-attention layer,
# patch 8 at 32x32: 16 trunk tokens, 17 in class attention.
SMALL = dict(embed_dim=32, num_layers=2, num_heads=2, num_layers_token_only=1,
             patch_shape=(8, 8), stoch_depth_rate=0.0)

CAIT_NAMES = [f"cait_{s}_{d}" for s, d in (("xxs", 24), ("xxs", 36), ("xs", 24), ("xs", 36),
                                            ("s", 24), ("s", 36), ("s", 48), ("m", 24),
                                            ("m", 36), ("m", 48))]


def small_flax_params(seed=0):
    """sav_tpu's init of the small CaiT as numpy, with the head and every
    LayerScale scale redrawn from a numpy seed (LayerScale at 0.1 ± 0.05)."""
    model = jax_create_model("cait_xxs_24", num_classes=10, **SMALL)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)),
                           is_training=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed + 1)
    params["head"]["kernel"] = rng.normal(0.0, 0.5, params["head"]["kernel"].shape).astype(np.float32)
    for block in [k for k in params if "block_" in k]:
        for ls in ("LayerScaleBlock_0", "LayerScaleBlock_1"):
            shape = params[block][ls]["scale"].shape
            params[block][ls]["scale"] = rng.uniform(0.05, 0.15, shape).astype(np.float32)
    return params


def small_port_model(params, **kw):
    model = create_model("cait_xxs_24", num_classes=10, image_size=32, **SMALL, **kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def _jax_model(backend):
    return jax_create_model("cait_xxs_24", num_classes=10, dtype=jnp.float32,
                            backend=backend, **SMALL)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_small_cait_logits_match_sav_tpu(backend):
    params = small_flax_params()
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jax_model = _jax_model(backend)
    ref = np.asarray(jax_model.apply({"params": params}, x, is_training=False))
    model = small_port_model(params, backend=backend).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1.0  # the drawn head makes the check non-vacuous
    np.testing.assert_allclose(out, ref, **TOL)


def test_cait_xxs_24_state_dict_matches_flax_tree_at_full_width():
    jax_model = jax_create_model("cait_xxs_24", num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0),
    )
    flax_tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    converted = params_from_flax(flax_tree)
    ours = create_model("cait_xxs_24").state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert tuple(ours["blocks.23.attn.to_qkv"].shape) == (192, 3, 4, 48)
    assert tuple(ours["blocks.23.attn.pre_softmax.kernel"].shape) == (4, 4)
    assert tuple(ours["ca_blocks.1.attn.to_q"].shape) == (192, 4, 48)
    assert tuple(ours["pos_embed.pos_embed"].shape) == (1, 196, 192)


def test_params_from_flax_refuses_unknown_keys():
    params = small_flax_params()
    params["block_0"]["Dropout_0"] = {"rate": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="CaiT port does not consume.*Dropout_0"):
        params_from_flax({"params": params})
    with pytest.raises(KeyError, match="not a ViT or CaiT"):
        params_from_flax({"TNTBlock_0": {"kernel": np.zeros((2, 2), np.float32)}})


def test_stochastic_depth_is_identity_at_rate_0_and_in_eval():
    x = torch.randn(4, 5, 8, generator=torch.Generator().manual_seed(0))
    assert StochasticDepthBlock(0.0).train()(x) is x
    block = StochasticDepthBlock(0.5).eval()
    assert block(x) is x  # eval: no generator needed
    with pytest.raises(RuntimeError, match="generator"):
        block.train()(x)  # training never falls back to the global RNG


@pytest.mark.parametrize("scale_by_keep", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stochastic_depth_with_injected_mask_matches_sav_tpu(scale_by_keep, dtype):
    """The same keep mask on both sides: sav_tpu's block with its bernoulli
    draw replaced by the mask, and the port's ``apply_mask``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 3, 4)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], bool).reshape(6, 1, 1)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_block = JaxStochasticDepth(drop_rate=0.25, scale_by_keep=scale_by_keep)
    with jax.disable_jit():
        real = jax.random.bernoulli
        jax.random.bernoulli = lambda key, p, shape: jnp.asarray(mask)
        try:
            ref = jax_block.apply({}, jnp.asarray(x, jdtype), True,
                                  rngs={"stochastic_depth": jax.random.PRNGKey(0)})
        finally:
            jax.random.bernoulli = real
    got = StochasticDepthBlock(0.25, scale_by_keep=scale_by_keep).apply_mask(
        torch.from_numpy(x).to(dtype), torch.from_numpy(mask))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    keep = 1.0 / 0.75 if scale_by_keep else 1.0
    np.testing.assert_allclose(got.float().numpy(), x * mask * keep, rtol=1e-2 if dtype == torch.bfloat16 else 1e-6)


def test_stochastic_depth_masks_follow_the_generator_seed():
    def masks(seed):
        model = create_model("cait_xxs_24", num_classes=10, image_size=32,
                             **{**SMALL, "stoch_depth_rate": 0.5}).train()
        assert set_stochastic_depth_generator(model, torch.Generator().manual_seed(seed)) == 4
        x = torch.ones(16, 4, 32)
        return [block(x)[:, 0, 0] for block in model.modules() if isinstance(block, StochasticDepthBlock)]

    a, b, c = masks(7), masks(7), masks(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert set(torch.cat(a).tolist()) == {0.0, 2.0}  # dropped, or kept and scaled by 1/0.5


def test_layerscale_init_and_dtype():
    block = LayerScaleBlock(8, eps=1e-5)
    block.reset_parameters()
    assert torch.equal(block.scale, torch.full((8,), 1e-5))
    model = create_model("cait_xxs_24", num_classes=10, image_size=32, **SMALL)
    scales = [m.scale for m in model.modules() if isinstance(m, LayerScaleBlock)]
    assert len(scales) == 2 * (2 + 1) and all(torch.all(s == 1e-5) for s in scales)
    x = torch.ones(2, 8, dtype=torch.bfloat16)
    assert block(x).dtype == torch.bfloat16


def test_registry_names():
    assert all(name in model_names() for name in CAIT_NAMES)
    for name in CAIT_NAMES:
        model = create_model(name, num_classes=10, image_size=32, patch_shape=(16, 16),
                             num_layers=1)
        assert isinstance(model, CaiT) and len(model.ca_blocks) == 2
    xxs = create_model("cait_xxs_24")
    assert len(xxs.blocks) == 24 and xxs.blocks[0].attn.num_heads == 4
    assert xxs.blocks[0].attn.head_ch == 48 and xxs.blocks[0].sd1.drop_rate == 0.05
    assert xxs.blocks[0].ls1.eps == 1e-5
    assert torch.count_nonzero(xxs.head.weight) == 0 and torch.count_nonzero(xxs.cls) == 0
    w = xxs.blocks[0].attn.pre_softmax.kernel
    torch.testing.assert_close(w @ w.T, torch.eye(4), atol=1e-5, rtol=0)  # orthogonal
    m48 = create_model("cait_m_48", num_layers=1)
    assert m48.blocks[0].attn.num_heads == 16 and m48.blocks[0].sd1.drop_rate == 0.4
