"""The port's ViT (sav_tpu_torch.models) against sav_tpu's, on the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs. The f32 tolerance is 1e-4:
XLA:CPU and torch sum the conv and the matmuls in different orders across
two layers.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers.feedforward import FFBlock as JaxFFBlock
from sav_tpu.models.layers.stems import PatchEmbedBlock as JaxPatchEmbed
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model, model_names
from sav_tpu_torch.models.layers import FFBlock, PatchEmbedBlock
from sav_tpu_torch.models.vit import ViT

torch.set_num_threads(2)

TOL = 1e-4
# embed 64, 2 layers, 2 heads of 32, patch 8 at 32x32: L = 1 + 16 = 17 (ragged).
SMALL = dict(embed_dim=64, num_layers=2, num_heads=2, patch_shape=(8, 8))


def small_flax_params(num_classes=10, image_size=32, seed=0, **options):
    """sav_tpu's init of the small ViT as numpy, with a random head (a fresh
    head is zero, which would make logit comparisons vacuous)."""
    model = jax_create_model("vit_ti_patch16", num_classes=num_classes, **SMALL, **options)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, image_size, image_size, 3)), is_training=False,
    )
    params = jax.tree.map(np.asarray, variables["params"])
    params["head"]["kernel"] = (
        np.random.default_rng(seed + 1)
        .normal(0.0, 0.5, params["head"]["kernel"].shape)
        .astype(np.float32)
    )
    return params


def small_port_model(params, **kw):
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **SMALL, **kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_small_vit_logits_match_sav_tpu(backend):
    params = small_flax_params()
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model(
        "vit_ti_patch16", num_classes=10, dtype=jnp.float32, backend=backend, **SMALL
    )
    ref = np.asarray(
        jax.jit(lambda p, x: jax_model.apply({"params": p}, x, is_training=False))(params, x)
    )
    model = small_port_model(params, backend=backend)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1.0  # the random head makes the check non-vacuous
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def _logits_and_grads(model, x, weights):
    """Logits and every parameter gradient of ``sum(logits * weights)``."""
    model.zero_grad()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(weights)).sum().backward()
    return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_vit_matches_sav_tpu_remat_vit():
    """``remat=True``: the flax tree of sav_tpu's ``ViT(remat=True)``
    converts unchanged (``nn.remat`` keeps ``block_i``), and the port's remat
    ViT at ``backend='pallas'`` (the flash kernels' plain versions here)
    agrees with it in the logits and every parameter gradient; the port's
    remat gradients equal its no-remat ones (tests/test_models.py's remat
    check, there at 1e-5). sav_tpu runs its dense path here: its Pallas flash
    kernels under remat are held against the port's in test_torch_train's
    4-step remat test."""
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    weights = np.random.default_rng(6).standard_normal((2, 10)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="xla", remat=True, **SMALL)
    params = small_flax_params()
    # The remat model's tree, by shape only (an eager init under nn.remat is slow).
    remat_tree = jax.eval_shape(
        lambda: jax_model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
                               is_training=False)
    )["params"]
    assert jax.tree.map(lambda a: a.shape, remat_tree) == jax.tree.map(np.shape, params)

    def loss(p):
        return jnp.sum(jax_model.apply({"params": p}, x, is_training=False) * weights)

    ref_logits = np.asarray(
        jax.jit(lambda p: jax_model.apply({"params": p}, x, is_training=False))(params)
    )
    ref_grads = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))

    model = small_port_model(params, backend="pallas", remat=True)
    assert model.encoder.remat
    logits, grads = _logits_and_grads(model, x, weights)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=TOL, rtol=TOL)
    assert set(grads) == set(ref_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
    _, plain_grads = _logits_and_grads(small_port_model(params, backend="pallas"), x, weights)
    for name, grad in grads.items():
        torch.testing.assert_close(grad, plain_grads[name], atol=1e-5, rtol=1e-5, msg=name)


def test_deit_s_state_dict_matches_flax_tree_at_full_width():
    jax_model = jax_create_model("deit_s_patch16", num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0),
    )
    flax_tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    assert len(jax.tree.leaves(flax_tree)) == 128
    converted = params_from_flax(flax_tree)
    ours = create_model("deit_s_patch16").state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert tuple(ours["encoder.blocks.11.attn.to_qkv"].shape) == (384, 3, 6, 64)


def test_params_from_flax_refuses_unknown_keys():
    # An MoE block's router and expert weights convert; a leaf no rule
    # names does not.
    params = small_flax_params()
    params["Encoder_0"]["block_0"]["MoEFFBlock_0"] = {"gate": np.zeros((64, 8), np.float32)}
    with pytest.raises(KeyError, match="MoEFFBlock_0/gate"):
        params_from_flax({"params": params})


def test_patch_embed_token_order_matches_flax():
    """NHWC input, HWIO kernel: tokens come out row-major over patches."""
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    block = JaxPatchEmbed(patch_shape=(8, 8), embed_dim=16)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(block.apply(variables, jnp.asarray(x)))
    ours = PatchEmbedBlock((8, 8), 16)
    kernel = np.asarray(variables["params"]["proj"]["kernel"])
    with torch.no_grad():
        ours.proj.weight.copy_(torch.tensor(kernel.transpose(3, 2, 0, 1)))
        ours.proj.bias.copy_(torch.tensor(np.asarray(variables["params"]["proj"]["bias"])))
        out = ours(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 6, 16)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_ffblock_uses_flax_tanh_gelu():
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32) * 3
    block = JaxFFBlock()
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x), is_training=False)
    ref = np.asarray(block.apply(variables, jnp.asarray(x), is_training=False))
    p = variables["params"]
    ours = FFBlock(32)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            layer = getattr(ours, name)
            layer.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_layernorm_eps_is_flax_default():
    model = create_model("vit_ti_patch16", image_size=32, **SMALL)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 5
    assert all(n.eps == fnn.LayerNorm().epsilon == 1e-6 for n in norms)


def test_registry_names_and_unported_entries():
    """Every sav_tpu name is in the registry and builds, the rotary and MoE
    ViTs (once refused, naming A2 and A7.7) with sav_tpu's options; an
    unknown name raises."""
    from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY

    from sav_tpu_torch.models.layers import MoEFFBlock

    assert "deit_s_patch16" in model_names()
    assert "tnt_s_patch16" in model_names() and "tnt_b_patch16" in model_names()
    assert {f"mixer_{s}_patch{p}" for s in "sbl" for p in (32, 16)} <= set(model_names())
    assert set(JAX_REGISTRY) == set(model_names())
    rope = create_model("vit_s_patch16_rope", **SMALL, image_size=32)
    assert rope.encoder.pos_embed is None and rope.encoder.blocks[0].attn.rotary is not None
    moe = create_model("vit_moe_s_patch16_e8", **SMALL, image_size=32)
    assert isinstance(moe.encoder.blocks[1].ff, MoEFFBlock) and moe.encoder.blocks[1].ff.top_k == 2
    with pytest.raises(ValueError, match="unknown model"):
        create_model("vit_xxl")


# The ROADMAP item each option waited on. The position modes (A2), the MoE
# (A7.7) and the int8 arm (A8) are carried now, as dropout is: they build
# and match sav_tpu.
CARRIED_ITEMS = (None, "A2", "A7.7", "A8")


@pytest.mark.parametrize(
    "option,item",
    [
        ({"moe_num_experts": 8}, "A7.7"),
        ({"dropout_rate": 0.1}, None),  # carried: see the body
        ({"quant": "int8"}, "A8"),
        ({"seq_parallel": "ring"}, "A9"),
        ({"pos_embed": "sincos"}, "A2"),
    ],
)
def test_unported_vit_options_raise(option, item, monkeypatch):
    """Each option the port does not carry raises, naming its ROADMAP item.
    The carried ones build: the ViT's eval forward is sav_tpu's eval
    forward on the same flax tree (8 experts routed in block 1; the
    sinusoidal table in place of the learned one; ``quant``: the QAT arm,
    test_torch_quant's check in f32), and with
    ``dropout_rate`` it drops in training (flax's nn.Dropout after the
    position embedding, in each FF block and on each attention output)."""
    if item not in CARRIED_ITEMS:
        with pytest.raises(NotImplementedError, match=item):
            ViT(10, 64, 1, 2, (8, 8), image_size=32, **option)
        return
    if "quant" in option:
        from test_torch_quant import _vit_case, quant_family_parity

        quant_family_parity(_vit_case(), option["quant"], "float32", monkeypatch)
        return
    from sav_tpu_torch.models.layers import set_dropout_generator

    dropout = "dropout_rate" in option
    params = small_flax_params() if dropout else small_flax_params(**option)
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="fused", **SMALL, **option)
    ref = np.asarray(jax_model.apply({"params": params}, x, is_training=False))
    model = small_port_model(params, backend="fused", **option)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), ref, atol=TOL, rtol=TOL)
    if not dropout:
        return
    assert set_dropout_generator(model, torch.Generator().manual_seed(0)) == 1 + 4 * 2
    with torch.no_grad():
        dropped = model.train()(torch.from_numpy(x)).numpy()
    assert np.isfinite(dropped).all() and np.abs(dropped - ref).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_serve"])
def test_small_deit_int8_arms_match_sav_tpu(quant, dtype, monkeypatch):
    """The small DeiT on the int8 arm against sav_tpu's, QAT and serving,
    f32 and bf16 (test_torch_quant.quant_family_parity); in f32 every code
    and logit is sav_tpu's, bit for bit (the dense f32 paths agree to the
    bit at this size)."""
    from test_torch_quant import _vit_case, quant_family_parity

    figures = quant_family_parity(_vit_case(), quant, dtype, monkeypatch)
    if dtype == "float32":
        assert figures["codes_differ"] == 0 and figures["max_abs_dlogit"] == 0.0
        assert figures["top1_rows_held"] == figures["rows"]


def test_create_model_is_deterministic_in_seed():
    a = create_model("vit_ti_patch16", image_size=32, seed=3, **SMALL).state_dict()
    b = create_model("vit_ti_patch16", image_size=32, seed=3, **SMALL).state_dict()
    c = create_model("vit_ti_patch16", image_size=32, seed=4, **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.blocks.0.attn.to_qkv"], c["encoder.blocks.0.attn.to_qkv"])
    assert torch.count_nonzero(a["head.weight"]) == 0 and torch.count_nonzero(a["cls"]) == 0


def test_f32_parameters_compute_in_the_input_dtype():
    """Every layer casts its weights to the activation dtype at use (flax's
    dtype=bf16 over f32 params): f32 parameters on bf16 images give exactly
    the logits of the module cast to bf16, which is what serving runs, and
    their gradients stay f32."""
    params = small_flax_params()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32))
    model = small_port_model(params)
    cast = small_port_model(params).to(torch.bfloat16)
    with torch.inference_mode():
        want = cast(x.bfloat16())
        got = model(x.bfloat16())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    model(x.bfloat16()).float().sum().backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
