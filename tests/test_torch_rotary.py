"""The port's position embeddings (sav_tpu_torch.ops.rotary and
models/layers/position_embed.py) and the ViT's position modes against
sav_tpu's, on the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs. Tolerances are those of
tests/test_fused_attention.py: f32 2e-5 on the tables and the rotation,
bf16 bit for bit at the cast point (both sides round after each op), and
the model logits of tests/test_torch_vit.py (1e-4: XLA:CPU and torch sum
the conv and the matmuls in other orders across two layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers.position_embed import (
    FixedPositionalEmbedding as JaxFixedPositionalEmbedding,
)
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.obs import costs as jax_costs
from sav_tpu.ops import rotary as jax_rotary
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names
from sav_tpu_torch.models.layers import (
    FixedPositionalEmbedding,
    RotaryPositionalEmbedding,
    SelfAttentionBlock,
    cast_for_compute,
)
from sav_tpu_torch.obs import costs
from sav_tpu_torch.ops import rotary

torch.set_num_threads(2)

F32_TOL = 2e-5
TOL = 1e-4
# embed 64, 2 layers, 4 heads of 16, patch 8 at 32x32: L = 1 + 16 = 17 (ragged).
SMALL = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8))
MODES = ("learned", "sincos", "rotary", "none")


@functools.cache
def small_flax_params(pos_embed: str, seed: int = 0):
    """sav_tpu's init of the small ViT in ``pos_embed`` mode as numpy, the
    zero head drawn at std 0.5 (a zero head makes every logit 0)."""
    model = jax_create_model("vit_ti_patch16", num_classes=10, pos_embed=pos_embed, **SMALL)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)),
                           is_training=False)
    params = jax.tree.map(np.asarray, variables["params"])
    params["head"]["kernel"] = np.random.default_rng(seed + 1).normal(
        0.0, 0.5, params["head"]["kernel"].shape).astype(np.float32)
    return params


def small_port_model(pos_embed: str, **kw):
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, pos_embed=pos_embed,
                         **SMALL, **kw)
    model.load_state_dict(params_from_flax(small_flax_params(pos_embed)), strict=True)
    return model.eval()


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("seq_len,dim", [(17, 16), (197, 64), (5, 2)])
def test_tables_match_sav_tpu(seq_len, dim):
    want = jax_rotary.fixed_positional_embedding(seq_len, dim)
    got = rotary.fixed_positional_embedding(seq_len, dim)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (seq_len, dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL, rtol=0)
    # Each frequency twice: columns 2i and 2i + 1 are one column.
    assert torch.equal(got[0][:, 0::2], got[0][:, 1::2])


def test_odd_dim_is_refused_as_sav_tpu_refuses_it():
    with pytest.raises(ValueError, match="must be even"):
        jax_rotary.fixed_positional_embedding(4, 5)
    with pytest.raises(ValueError, match="must be even"):
        rotary.fixed_positional_embedding(4, 5)


def test_rotate_every_two_matches_sav_tpu():
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 8)).astype(np.float32)
    got = rotary.rotate_every_two(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rotary.rotate_every_two(jnp.asarray(x))))
    np.testing.assert_array_equal(got[..., :2], np.stack([-x[..., 1], x[..., 0]], -1))


@pytest.mark.parametrize("shape", [(2, 17, 4, 16), (3, 17, 16)])
def test_f32_rotation_matches_sav_tpu(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    tables = jax_rotary.fixed_positional_embedding(17, 16)
    want = np.asarray(jax_rotary.apply_rotary_pos_emb(jnp.asarray(x), tables))
    got = rotary.apply_rotary_pos_emb(torch.from_numpy(x),
                                      rotary.fixed_positional_embedding(17, 16))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_rotation_rounds_at_sav_tpus_cast_point():
    """q and k of DeiT-S's shape in bf16: the f32 tables are cast to bf16,
    then each product and the sum round in bf16, which is what XLA computes
    for sav_tpu's expression on the CPU: bit for bit, given the same tables.
    Keeping the sum in f32 and rounding once (XLA's excess precision on
    other backends) would move about a quarter of the outputs by an ulp: the
    port does not."""
    x = np.random.default_rng(2).standard_normal((2, 197, 6, 64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tables = jax_rotary.fixed_positional_embedding(197, 64)
    want = np.asarray(jax.jit(jax_rotary.apply_rotary_pos_emb)(xb, tables).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    sin, cos = (torch.from_numpy(np.asarray(t)) for t in tables)
    got = rotary.apply_rotary_pos_emb(xt, (sin, cos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    s, c = sin[None, :, None].bfloat16().float(), cos[None, :, None].bfloat16().float()
    once = (xt.float() * c + rotary.rotate_every_two(xt).float() * s).bfloat16()
    assert (once.float().numpy() != want).mean() > 0.1


# ----------------------------------------------------------------- layers


def test_fixed_positional_embedding_matches_sav_tpu():
    """sin on the even channels, cos on the odd ones, added in the input
    dtype (f32 here, bf16 against sav_tpu in bf16)."""
    x = np.random.default_rng(3).standard_normal((2, 17, 64)).astype(np.float32)
    module = JaxFixedPositionalEmbedding()
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, F32_TOL),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        want = np.asarray(module.apply({}, jnp.asarray(x).astype(jdtype)).astype(jnp.float32))
        got = FixedPositionalEmbedding(17, 64)(torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    sin, cos = rotary.fixed_positional_embedding(17, 64)
    table = FixedPositionalEmbedding(17, 64).table
    assert torch.equal(table[:, 0::2], sin[:, 0::2]) and torch.equal(table[:, 1::2], cos[:, 1::2])


def test_tables_are_buffers_made_on_the_modules_device_and_kept_out_of_the_state():
    """Non-persistent f32 buffers: made at construction (and again by
    reset_parameters after a build on the meta device), absent from the
    state dict; a shorter input takes their first rows, a longer one is
    refused; cast to bf16 with the rest of a serving model, they give the
    logits of the f32 tables cast at use."""
    rope = RotaryPositionalEmbedding(17, 16)
    assert rope.state_dict() == {} and rope.sin.dtype == torch.float32
    assert torch.equal(rope.sin, rotary.fixed_positional_embedding(17, 16)[0])
    x = torch.randn(2, 5, 3, 16)
    want = rotary.apply_rotary_pos_emb(x, rotary.fixed_positional_embedding(5, 16))
    np.testing.assert_allclose(rope(x).numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="17 positions"):
        rope(torch.randn(1, 18, 16))
    model = create_model("vit_s_patch16_rope", num_classes=10, image_size=32, **SMALL)
    tables = [m for m in model.modules() if isinstance(m, RotaryPositionalEmbedding)]
    assert len(tables) == SMALL["num_layers"]
    for m in tables:
        assert torch.equal(m.sin, rotary.fixed_positional_embedding(17, 16)[0])
    assert not any("sin" in k or "cos" in k for k in model.state_dict())
    torch.nn.init.normal_(model.head.weight, std=0.5, generator=torch.Generator().manual_seed(0))
    images = torch.randn(2, 32, 32, 3).bfloat16()
    with torch.no_grad():
        want = model.eval()(images)
        got = cast_for_compute(model, torch.bfloat16)(images)
    assert tables[0].sin.dtype == torch.bfloat16 and torch.equal(got, want)


def test_rotary_self_attention_rotates_q_and_k_before_the_core():
    """The block rotates q and k after the projections (the dense core
    recomputed here by hand on the rotated q and k), not v."""
    torch.manual_seed(0)
    block = SelfAttentionBlock(64, 4, use_rotary=True, rotary_length=17, backend="xla")
    block.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 17, 64)
    w = block.to_qkv.reshape(64, 3, 64)
    q, k, v = ((x @ w[:, t]).view(2, 17, 4, 16) for t in range(3))
    tables = rotary.fixed_positional_embedding(17, 16)
    q, k = rotary.apply_rotary_pos_emb(q, tables), rotary.apply_rotary_pos_emb(k, tables)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(2, 17, 64) @ block.to_out.reshape(64, 64)
    np.testing.assert_allclose(block(x).detach().numpy(), out.detach().numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


# ------------------------------------------------------------------ models


def test_rope_vit_gradients_match_sav_tpu():
    """Every gradient of Σ logits² of the small rotary ViT at backend fused
    (the fused kernels' plain backward here, the Pallas backward in
    interpret mode there); f32 gradient tolerances 1e-4 / 5e-4."""
    params = small_flax_params("rotary")
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="fused", pos_embed="rotary", **SMALL)

    def loss(p):
        return jnp.sum(jax_model.apply({"params": p}, x, is_training=False) ** 2)

    grads = params_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    model = small_port_model("rotary", backend="fused")
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=atol, rtol=5e-4, err_msg=name)
    assert float(model.encoder.blocks[0].attn.to_qkv.grad.abs().max()) > 1e-3


@pytest.mark.parametrize("mode", ["sincos", "rotary", "none"])
def test_interop_round_trip_without_a_position_table(mode):
    params = small_flax_params(mode)
    assert "AddAbsPosEmbed_0" not in params["Encoder_0"]
    state = params_from_flax(params)
    assert not any("pos_embed" in k for k in state)
    back = flax_from_params(state, "ViT")["params"]
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


def test_registry_rope_entry_matches_sav_tpu_tree_at_full_size():
    """vit_s_patch16_rope at 224², built on the meta device: every tensor
    has the shape sav_tpu's tree converts to, and the entry's fields are
    sav_tpu's."""
    fields = JAX_REGISTRY["vit_s_patch16_rope"][1]
    assert fields["pos_embed"] == "rotary" and fields["embed_dim"] == 384
    jax_model = jax_create_model("vit_s_patch16_rope", num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                              shapes["params"]))
    model = create_model("vit_s_patch16_rope")
    ours = model.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert "vit_s_patch16_rope" in model_names()
    rope = model.encoder.blocks[11].attn.rotary
    assert (rope.length, rope.dim) == (197, 64) and model.encoder.pos_embed is None


def test_rope_vit_keeps_its_analytic_cost():
    """No position table: both counts take 197 tokens from the patch-embed
    kernel and the CLS token, and agree."""
    params = small_flax_params("rotary")
    want = jax_costs.analytic_train_step_cost(params, batch_size=16, image_size=32)
    model = small_port_model("rotary")
    got = costs.train_step_cost(model, batch_size=16, image_size=32)
    assert got.num_tokens == want.num_tokens == 17
    np.testing.assert_allclose(got.flops, want.flops, rtol=1e-9)
    full = costs.infer_num_tokens(costs.model_params_tree(create_model("vit_s_patch16_rope")), 224)
    assert full == 197
