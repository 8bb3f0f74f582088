"""The port's TNT (sav_tpu_torch.models.tnt: PixelEmbedBlock, Inner2OuterBlock,
EncoderBlock) and the attention seam at head dims off the multiple of 8,
against sav_tpu's, on the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs; sav_tpu runs its Pallas
kernels in interpret mode (they pad the head dim to 128 lanes), the port
the kernels' plain versions on the head dim zero-padded to 8 or 16. The
inner streams are TNT-S's and TNT-B's (4 heads of 6 and of 10), narrower
elsewhere. The head starts at zero, so the tests draw it first. Tolerances
are tests/test_models.py's on logits (f32 atol 1e-4, rtol 5e-3; gradients
atol 1e-4 of each tensor's largest entry) and tests/test_fused_attention.py's
on attention (f32 forward 2e-5, gradients 1e-4/5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.models.tnt import Inner2OuterBlock as JaxInner2OuterBlock
from sav_tpu.models.tnt import PixelEmbedBlock as JaxPixelEmbedBlock
from sav_tpu.ops.attention import xla_attention
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names, registry
from sav_tpu_torch.models.layers import same_pads, set_dropout_generator
from sav_tpu_torch.models.tnt import TNT, Inner2OuterBlock, PixelEmbedBlock
from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.ops import fused_attention as port_fused
from sav_tpu_torch.train import optimizer as port_optimizer

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=5e-3)
GRAD_RTOL, GRAD_ATOL_OF_LARGEST = 5e-3, 1e-4
ATTN_TOL, ATTN_GRAD_ATOL, ATTN_GRAD_RTOL = 2e-5, 1e-4, 5e-4
# Outer: embed 32, 2 heads of 16, 2 layers; inner: 4 heads of 6 (TNT-S) or
# 10 (TNT-B); 16×16 patches of a 32² image: 4 patches of 4×4 pixel tokens.
IMAGE = 32
INNER_DIMS = (6, 10)


def small(inner_dim):
    return dict(embed_dim=32, num_layers=2, num_heads=2, inner_ch=4 * inner_dim,
                inner_num_heads=4)


def assert_grad_close(got, want, name):
    atol = GRAD_ATOL_OF_LARGEST * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def init_flax(module, *args, seed=0, **kw):
    init = jax.jit(lambda r: module.init({"params": r}, *args, **kw))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def jax_small_tnt(inner_dim, backend="xla", **kw):
    return jax_create_model("tnt_s_patch16", num_classes=10, dtype=jnp.float32, backend=backend,
                            **small(inner_dim), **kw)


def small_flax_params(inner_dim, seed=0):
    """sav_tpu's init of the small TNT, the zero head drawn at std 0.05."""
    params = init_flax(jax_small_tnt(inner_dim), jnp.zeros((1, IMAGE, IMAGE, 3)),
                       is_training=False, seed=seed)["params"]
    rng = np.random.default_rng(seed + 1)
    params["head"]["kernel"] = rng.normal(0.0, 0.05, params["head"]["kernel"].shape).astype(
        np.float32)
    return params


def small_port_model(params, inner_dim, **kw):
    model = create_model("tnt_s_patch16", num_classes=10, image_size=IMAGE, **small(inner_dim),
                         **kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def sub_state(state, prefix):
    return {k.removeprefix(prefix): v for k, v in state.items() if k.startswith(prefix)}


@pytest.fixture(scope="module", params=INNER_DIMS, ids=lambda d: f"inner_dim{d}")
def inner(request):
    return request.param, small_flax_params(request.param)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("patch", [16, 8])
def test_pixel_embed_matches_sav_tpu(patch):
    """Patches in flax's order (patch rows, then columns), each through the
    7×7/4 SAME conv (pads (1, 2) at 16 and at 8), the map read row-major:
    [B·P, inner tokens, C]."""
    assert same_pads(16, 7, 4) == same_pads(8, 7, 4) == (1, 2)
    x = np.random.default_rng(0).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_block = JaxPixelEmbedBlock(patch_shape=(patch, patch), inner_ch=12)
    params = init_flax(jax_block, x)["params"]
    want = np.asarray(jax_block.apply({"params": params}, x))
    block = PixelEmbedBlock((patch, patch), 12)
    block.load_state_dict({"proj.weight": torch.from_numpy(
        params["proj"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "proj.bias": torch.from_numpy(params["proj"]["bias"].copy())}, strict=True)
    got = block(torch.from_numpy(x)).detach().numpy()
    side = -(-patch // 4)
    assert got.shape == want.shape == (2 * (IMAGE // patch) ** 2, side * side, 12)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # The second patch of the first image is the top row's second: moving
    # its pixels moves its tokens only.
    moved = x.copy()
    moved[0, :patch, patch:2 * patch] += 1.0
    diff = np.abs(block(torch.from_numpy(moved)).detach().numpy() - got).max(axis=(1, 2))
    assert diff[1] > 0 and np.all(np.delete(diff, 1) == 0)


def test_inner2outer_matches_sav_tpu_with_gradients():
    """Each patch's pixel tokens flattened token-major, LN, Dense, added to
    the patch tokens past CLS (CLS untouched); the output and every
    gradient of Σ out²."""
    rng = np.random.default_rng(1)
    pixel = rng.standard_normal((2 * 4, 16, 6)).astype(np.float32)
    patch = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jax_block = JaxInner2OuterBlock(embed_dim=32)
    params = init_flax(jax_block, jnp.asarray(pixel), jnp.asarray(patch))["params"]

    def jax_loss(p, pixel, patch):
        out = jax_block.apply({"params": p}, pixel, patch)
        return jnp.sum(out ** 2), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(pixel), jnp.asarray(patch))
    block = Inner2OuterBlock(16 * 6, 32)
    block.load_state_dict({
        "norm.weight": torch.from_numpy(params["LayerNorm_0"]["scale"].copy()),
        "norm.bias": torch.from_numpy(params["LayerNorm_0"]["bias"].copy()),
        "proj.weight": torch.from_numpy(params["proj"]["kernel"].T.copy()),
        "proj.bias": torch.from_numpy(params["proj"]["bias"].copy())}, strict=True)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (pixel, patch)]
    got = block(*inputs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got.detach().numpy()[:, 0], patch[:, 0])
    (got ** 2).sum().backward()
    for t, g, name in zip(inputs, grads[1:], ("pixel", "patch")):
        assert_grad_close(t.grad.numpy(), np.asarray(g), name)
    g = jax.tree.map(np.asarray, grads[0])
    assert_grad_close(block.proj.weight.grad.numpy(), g["proj"]["kernel"].T, "proj")
    assert_grad_close(block.norm.weight.grad.numpy(), g["LayerNorm_0"]["scale"], "norm")


# ------------------------------------------- attention at head dims 6 and 10


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d))]


@pytest.mark.parametrize("backend", [None, "fused", "pallas"])
@pytest.mark.parametrize("dim", INNER_DIMS)
def test_padded_head_dim_matches_xla_attention(dim, backend):
    """The seam at head dim 6 and 10 and q_len != kv_len: q, k, v padded
    with zero columns to 8 or 16 before the kernels (their plain versions
    here), the scale of the true head dim, the output and the gradients
    sliced back; against sav_tpu's xla_attention in f32."""
    arrays = _qkv(3, 16, 9, 4, dim, seed=dim)

    def jax_loss(q, k, v):
        out = xla_attention(q, k, v, logits_dtype=jnp.float32)
        return jnp.sum(out ** 2), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_attention.dot_product_attention(*tensors, scale=dim ** -0.5, backend=backend)
    assert out.shape == (3, 16, 4, dim)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    (out ** 2).sum().backward()
    for t, g in zip(tensors, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATTN_GRAD_ATOL,
                                   rtol=ATTN_GRAD_RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", INNER_DIMS)
def test_auto_takes_the_fused_kernels_at_tnt_inner_shapes(dim, dtype):
    """auto takes #1 (and, under grad, #2) at (16, 16, 6) and (16, 16, 10):
    within the padded head dim's band, through the fused autograd Function
    on the padded tensors, the pad's own backward slicing the gradients."""
    resolve = port_attention.resolve_attention_backend
    for backward in (False, True):
        assert resolve(16, 16, dim, dtype=dtype, backward=backward) == "fused"
    assert port_fused.padded_dim(dim) == (8 if dim == 6 else 16)
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in _qkv(2, 16, 16, 4, dim, 1))
    out = port_attention.dot_product_attention(q, k, v)
    assert out.shape == (2, 16, 4, dim) and out.dtype == dtype
    names, fn = [], out.grad_fn
    while fn is not None and fn.next_functions:
        names.append(type(fn).__name__)
        fn = fn.next_functions[0][0]
    assert any("FusedAttention" in n for n in names) and any("Constant" in n or "Pad" in n
                                                              for n in names)
    out.float().sum().backward()
    assert q.grad.shape == (2, 16, 4, dim)
    # The lse of the padded call is the unpadded one's.
    with torch.no_grad():
        _, lse = port_fused.fused_attention(q, k, v, with_lse=True)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dim ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=1e-5)


def test_fused_backward_wrapper_pads_and_slices():
    """fused_attention_bwd called directly at head dim 6 (as the card's
    check calls it) equals the plain backward at the true head dim."""
    q, k, v, g = (torch.randn(2, 16, 4, 6, generator=torch.Generator().manual_seed(i))
                  for i in range(4))
    out, lse = port_fused.fused_attention(q, k, v, with_lse=True)
    got = port_fused.fused_attention_bwd(q, k, v, out, lse, g)
    want = port_fused.fused_attention_bwd_reference(q, k, v, out, lse, g)
    for a, b in zip(got, want):
        assert a.shape == (2, 16, 4, 6)
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------- model


def test_dropout_sites_and_zero_head():
    """flax's nn.Dropout sites: one on the patch stream after its position
    table, and in each block two per attention block (probabilities,
    output) and two per FF block, on both streams; the zero-init head
    makes every logit 0."""
    model = create_model("tnt_s_patch16", num_classes=10, image_size=IMAGE, dropout_rate=0.1,
                         **small(6))
    assert set_dropout_generator(model, torch.Generator().manual_seed(0)) == 1 + 2 * 8
    assert torch.count_nonzero(model.head.weight) == 0 and torch.count_nonzero(model.cls) == 0
    with torch.no_grad():
        assert torch.count_nonzero(model.eval()(torch.randn(2, IMAGE, IMAGE, 3))) == 0


# ------------------------------------------------------ interop, registry


def test_interop_round_trip_is_exact(inner):
    inner_dim, params = inner
    state = params_from_flax(params)
    assert state["pixel_embed.proj.weight"].shape == (4 * inner_dim, 3, 7, 7)
    assert state["blocks.0.inner_attn.to_qkv"].shape == (4 * inner_dim, 3, 4, inner_dim)
    assert state["blocks.0.inner2outer.proj.weight"].shape == (32, 16 * 4 * inner_dim)
    back = flax_from_params(state, "TNT")
    flat = jax.tree_util.tree_flatten_with_path(back["params"])[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(back) == {"params"} and len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    bad = {**params, "block_0": {**params["block_0"], "Dropout_0": {"rate": np.zeros(1)}}}
    with pytest.raises(KeyError, match="TNT port does not consume.*Dropout_0"):
        params_from_flax(bad)


@pytest.mark.parametrize("name", ["tnt_s_patch16", "tnt_b_patch16"])
def test_registry_entry_matches_sav_tpu_tree_at_full_size(name):
    """Built on the meta device at 224², every port tensor has the shape the
    sav_tpu tree converts to, and the config fields are sav_tpu's
    (un-swapped: TNT-S inner heads of 6, TNT-B of 10)."""
    fields = JAX_REGISTRY[name][1]
    embed_dim, inner_ch, num_layers, num_heads, inner_heads = registry._TNT[name]
    assert (fields["embed_dim"], fields["inner_ch"], fields["num_layers"], fields["num_heads"],
            fields["inner_num_heads"], fields["patch_shape"]) == (
        embed_dim, inner_ch, num_layers, num_heads, inner_heads, (16, 16))
    assert inner_ch // inner_heads == {"tnt_s_patch16": 6, "tnt_b_patch16": 10}[name]
    jax_model = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = TNT(1000, embed_dim, inner_ch, num_layers, num_heads, inner_heads, (16, 16))
    ours = ours.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert name in model_names()


def test_registry_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="A9"):
        create_model("tnt_s_patch16", seq_parallel="ring")


def test_weight_decay_mask_on_the_tnt_tree_matches_sav_tpu(inner):
    inner_dim, params = inner
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("tnt_s_patch16", num_classes=10, image_size=IMAGE, **small(inner_dim))
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["pixel_embed.proj.weight"] and got["blocks.0.inner_attn.to_qkv"]
    assert not got["cls"] and not got["inner_pos_embed.pos_embed"]
