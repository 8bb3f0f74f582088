"""The port's CvT (sav_tpu_torch.models.cvt and its conv-projection
attention, sav_tpu_torch.models.layers.cvt_attention) against sav_tpu's, on
the CPU.

Both sides take the same flax variables (the port's through
``params_from_flax``, ``batch_stats`` included) and the same numpy inputs;
sav_tpu runs its Pallas kernels in interpret mode, the port the kernels'
plain versions. CvT strides K and V 2×, so every attention core here has
``q_len ≠ kv_len``: at 64² with ``embed_dims (16, 32, 64)`` stage 1 is 256
queries over 64 keys, stage 2 64 over 16, stage 3 17 over 5. The head
starts at zero and the running statistics at 0/1, so the tests draw them
first. Tolerances are tests/test_models.py's and
tests/test_torch_botnet.py's: f32 atol 1e-4, rtol 5e-3; gradients atol 1e-4
of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers import ConvProjectionBlock as JaxConvProjectionBlock
from sav_tpu.models.layers import CvTAttentionBlock as JaxCvTAttentionBlock
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names, registry
from sav_tpu_torch.models.cvt import CvT
from sav_tpu_torch.models.layers import ConvProjectionBlock, CvTAttentionBlock
from sav_tpu_torch.obs import costs
from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.train import optimizer as port_optimizer
from test_torch_ceit import (
    TOL,
    assert_grad_close,
    bn_state,
    draw_stats,
    draw_variables,
    flax_train_forward,
    init_flax,
    load,
)

torch.set_num_threads(2)

SMALL = dict(embed_dims=(16, 32, 64), num_layers=(1, 1, 1), num_heads=(1, 2, 4))
IMAGE = 64
CVT_NAMES = ("cvt-13", "cvt-21", "cvt-w24")


def jax_small_cvt(backend):
    return jax_create_model("cvt-13", num_classes=10, dtype=jnp.float32, backend=backend, **SMALL)


def small_flax_variables(seed=0):
    """sav_tpu's init of the small CvT, with the head and running
    statistics drawn (test_torch_ceit.draw_variables)."""
    variables = init_flax(jax_small_cvt("xla"), jnp.zeros((1, IMAGE, IMAGE, 3)),
                          is_training=False, seed=seed)
    return draw_variables(variables, seed + 1)


def small_port_model(variables, **kw):
    model = create_model("cvt-13", num_classes=10, image_size=IMAGE, **SMALL, **kw)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def variables():
    return small_flax_variables()


# ------------------------------------------------------- conv projection


def _proj_state(params, stats, prefix=""):
    return {f"{prefix}depthwise.weight": params["depthwise"]["kernel"].transpose(3, 2, 0, 1),
            **bn_state(f"{prefix}bn.", params["bn"], stats["bn"]),
            f"{prefix}pointwise": params["pointwise"]["kernel"]}


@pytest.mark.parametrize("with_cls,stride,training", [(False, 1, True), (False, 2, True),
                                                      (True, 2, True), (True, 2, False)])
def test_conv_projection_matches_sav_tpu(with_cls, stride, training):
    """Depthwise conv and BatchNorm on the 6×6 grid (stride 2: 3×3), the
    CLS token (``with_cls``) skipping both and joining before the
    pointwise projection to [heads, head_ch]; train mode also the running
    statistics."""
    rng = np.random.default_rng(1)
    length = 36 + with_cls
    x = rng.standard_normal((2, length, 8)).astype(np.float32)
    jax_proj = JaxConvProjectionBlock(num_heads=2, head_ch=4, stride=stride, with_cls=with_cls)
    raw = init_flax(jax_proj, x, (6, 6), is_training=False)
    variables = {"params": raw["params"], "batch_stats": draw_stats(raw["batch_stats"], rng)}
    proj = load(ConvProjectionBlock(8, 2, 4, stride=stride, with_cls=with_cls),
                _proj_state(variables["params"], variables["batch_stats"])).train(training)
    got = proj(torch.from_numpy(x), (6, 6)).detach().numpy()
    if training:
        want, stats = flax_train_forward(jax_proj, variables, x, (6, 6))
    else:
        want = np.asarray(jax_proj.apply(variables, x, (6, 6), is_training=False))
        stats = variables["batch_stats"]
    assert got.shape == want.shape == (2, (36 if stride == 1 else 9) + with_cls, 2, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(proj.bn.running_mean.numpy(), stats["bn"]["mean"], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(proj.bn.running_var.numpy(), stats["bn"]["var"], atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------- attention


def _attention_pair(backend, talking_heads, seed=2):
    """sav_tpu's CvTAttentionBlock and the port's on an 8×8 grid with CLS
    (q 65, kv 17), 2 heads of 8, the port loaded from sav_tpu's variables."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 65, 16)).astype(np.float32)
    jax_block = JaxCvTAttentionBlock(num_heads=2, with_cls=True, backend=backend,
                                     talking_heads=talking_heads)
    raw = init_flax(jax_block, x, (8, 8), is_training=False)
    variables = {"params": raw["params"], "batch_stats": draw_stats(raw["batch_stats"], rng)}
    p, s = variables["params"], variables["batch_stats"]
    state = {"to_out": p["to_out"]["kernel"]}
    for n in ("q", "k", "v"):
        state.update(_proj_state(p[f"to_{n}"], s[f"to_{n}"], prefix=f"to_{n}."))
    if talking_heads:
        state.update({f"{n}_softmax.kernel": p[f"{n}_softmax"]["kernel"] for n in ("pre", "post")})
    block = load(CvTAttentionBlock(16, 2, with_cls=True, backend=backend,
                                   talking_heads=talking_heads), state)
    return x, jax_block, variables, block


@pytest.mark.parametrize("backend,talking_heads", [("fused", False), ("pallas", False),
                                                   ("xla", False), ("xla", True)])
def test_cvt_attention_matches_sav_tpu_at_q_len_above_kv_len(backend, talking_heads):
    """65 queries over 17 keys and values (K/V strided 2× on the 8×8 grid,
    CLS carried), at each backend the port has (sav_tpu's Pallas kernels in
    interpret mode) and with talking heads (the dense path on both sides):
    the train-mode output and every gradient of Σ out² (the kernels'
    backward plain versions at q ≠ kv), and the running statistics."""
    x, jax_block, variables, block = _attention_pair(backend, talking_heads)

    def loss(params, x):
        out, new = jax_block.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   x, (8, 8), is_training=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, new["batch_stats"])

    (_, (want, stats)), (grads, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    got = block.train()(xt, (8, 8))
    (got ** 2).sum().backward()
    assert tuple(got.shape) == (3, 65, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert_grad_close(xt.grad.numpy(), np.asarray(dx), "inputs")
    grads = jax.tree.map(np.asarray, grads)
    stats = jax.tree.map(np.asarray, stats)
    want_grads = {"to_out": grads["to_out"]["kernel"]}
    for n in ("q", "k", "v"):
        g = grads[f"to_{n}"]
        want_grads.update({f"to_{n}.depthwise.weight": g["depthwise"]["kernel"].transpose(3, 2, 0, 1),
                           f"to_{n}.bn.weight": g["bn"]["scale"], f"to_{n}.bn.bias": g["bn"]["bias"],
                           f"to_{n}.pointwise": g["pointwise"]["kernel"]})
        bn = getattr(block, f"to_{n}").bn
        np.testing.assert_allclose(bn.running_var.numpy(), stats[f"to_{n}"]["bn"]["var"],
                                   atol=1e-6, rtol=1e-5)
    if talking_heads:
        want_grads.update({f"{n}_softmax.kernel": grads[f"{n}_softmax"]["kernel"]
                           for n in ("pre", "post")})
    got_grads = dict(block.named_parameters())
    assert set(got_grads) == set(want_grads)
    for name, param in got_grads.items():
        assert_grad_close(param.grad.numpy(), want_grads[name], name)


def test_cvt_attention_dispatch_at_cvt13_shapes():
    """``auto`` at CvT-13's 224² shapes (head dim 64, bf16, training): stage
    1's 3,136 queries over 784 keys are past the fused forward's band and
    take the flash kernels; stage 2 (784 over 196) and stage 3 (197 over
    50) the fused ones."""
    rule = port_attention.resolve_attention_backend
    assert rule(3136, 784, 64, backward=True) == "pallas"
    assert rule(3136, 784, 64, backward=False) == "pallas"
    for q_len, kv_len in ((784, 196), (197, 50)):
        assert rule(q_len, kv_len, 64, backward=True) == "fused"
        assert rule(q_len, kv_len, 64, backward=False) == "fused"


# ------------------------------------------------------------------ model


def test_zero_head_hides_the_trunk():
    model = create_model("cvt-13", num_classes=10, image_size=IMAGE, **SMALL)
    assert torch.count_nonzero(model.head.weight) == 0
    assert torch.count_nonzero(model.stages[2].cls) == 0
    assert not hasattr(model.stages[0], "cls") and not hasattr(model.stages[1], "cls")
    x = torch.randn(2, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.count_nonzero(model.eval()(x)) == 0


# ------------------------------------------------------ interop, registry


def test_interop_round_trip_is_exact(variables):
    state = params_from_flax(variables)
    assert state["stages.0.blocks.0.attn.to_out"].shape == (1, 16, 16)  # [H, D, out], (-2, -1)
    assert state["stages.2.blocks.0.attn.to_q.pointwise"].shape == (64, 4, 16)
    assert state["stages.1.blocks.0.attn.to_v.depthwise.weight"].shape == (32, 1, 3, 3)
    assert state["stages.0.embed.proj.weight"].shape == (16, 3, 7, 7)
    back = flax_from_params(state, "CvT")
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    with pytest.raises(RuntimeError, match="running_mean"):  # params alone: no statistics
        create_model("cvt-13", num_classes=10, image_size=IMAGE, **SMALL).load_state_dict(
            params_from_flax(variables["params"]), strict=True)
    bad = {**variables["params"], "stage_1": {**variables["params"]["stage_1"],
                                              "Dropout_0": {"rate": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="CvT port does not consume.*Dropout_0"):
        params_from_flax({"params": bad, "batch_stats": variables["batch_stats"]})


def test_talking_heads_kernels_round_trip():
    """A CvT built with talking heads: the [H, H] mixing kernels convert
    both ways too."""
    jax_block = JaxCvTAttentionBlock(num_heads=2, talking_heads=True)
    x = np.zeros((1, 16, 8), np.float32)
    params = init_flax(jax_block, x, (4, 4), is_training=False)["params"]
    tree = {"stage_0": {"block_0": {"CvTSelfAttentionBlock_0": {
        n: params[n] for n in ("pre_softmax", "post_softmax")}}}}
    state = params_from_flax(tree)
    assert set(state) == {"stages.0.blocks.0.attn.pre_softmax.kernel",
                          "stages.0.blocks.0.attn.post_softmax.kernel"}
    back = flax_from_params(state, "CvT")["params"]
    for n in ("pre_softmax", "post_softmax"):
        np.testing.assert_array_equal(
            back["stage_0"]["block_0"]["CvTSelfAttentionBlock_0"][n]["kernel"], params[n]["kernel"])


@pytest.mark.parametrize("name", CVT_NAMES)
def test_registry_entry_matches_sav_tpu_tree_at_full_size(name):
    """Built on the meta device, every port tensor has the shape the
    sav_tpu tree converts to, and the config fields are sav_tpu's."""
    fields = JAX_REGISTRY[name][1]
    assert (fields["embed_dims"], fields["num_layers"], fields["num_heads"]) == registry._CVT[name]
    jax_model = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = CvT(1000, fields["embed_dims"], fields["num_layers"], fields["num_heads"])
    ours = ours.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert name in model_names()


def test_registry_refuses_unported_options():
    with pytest.raises(TypeError, match="unexpected option"):
        create_model("cvt-13", seq_parallel="ring")


def test_weight_decay_mask_on_the_cvt_tree_matches_sav_tpu(variables):
    params = variables["params"]
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("cvt-13", num_classes=10, image_size=IMAGE, **SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["stages.0.blocks.0.attn.to_q.pointwise"] and got["stages.0.blocks.0.attn.to_out"]
    assert got["stages.1.blocks.0.attn.to_k.depthwise.weight"]
    assert not got["stages.2.cls"] and not got["stages.0.blocks.0.attn.to_q.bn.weight"]


@pytest.mark.parametrize("name,overrides,size", [("cvt-13", SMALL, IMAGE),
                                                 ("ceit_s", dict(embed_dim=32, num_layers=2,
                                                                 num_heads=2), 32)])
def test_step_cost_refuses_the_conv_families(name, overrides, size):
    """CvT's three stages and CeiT's stem run at token counts of their own,
    which sav_tpu's one-trunk-length count would miss; the port counts them
    with its own per-family count (no longer refused), equal to the dense
    forward's matmul and conv FLOPs (the flax tree itself converts too)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = create_model(name, num_classes=10, image_size=size, backend="xla", **overrides)
    assert "head" in costs.model_params_tree(model)
    cost = costs.train_step_cost(model, batch_size=2, image_size=size)
    with FlopCounterMode(display=False) as counter:
        model.eval()(torch.zeros(2, size, size, 3))
    assert cost.source == "analytic"
    assert cost.flops == pytest.approx(3 * counter.get_total_flops(), rel=1e-6)
