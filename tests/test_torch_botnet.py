"""The port's BoTNet (sav_tpu_torch.models.botnet and its layers) against
sav_tpu's, on the CPU.

Both sides take the same flax variables (the port's through
``params_from_flax``, ``batch_stats`` included) and the same numpy inputs.
At init every ``bn3`` scale and the head are zero, so every residual branch
(the attention's included) and every logit is 0, and the running statistics
sit at 0/1: the tests draw all of them first. Tolerances are those of
tests/test_torch_cait.py: f32 atol 1e-4, rtol 5e-3. About 50 s in one
process.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers import BoTMHSA as JaxBoTMHSA
from sav_tpu.models.layers import SqueezeExciteBlock as JaxSqueezeExcite
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model, model_names, registry
from sav_tpu_torch.models.botnet import BoTNet, attention_grids
from sav_tpu_torch.models.layers import (
    BatchNorm,
    BoTMHSA,
    SameConv2d,
    SqueezeExciteBlock,
    max_pool_same,
    same_pads,
)
from sav_tpu_torch.train import optimizer as port_optimizer

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=5e-3)
# Train-mode gradients: rtol 5e-3 and atol 1e-4 of the tensor's largest
# entry. BatchNorm's train-mode backward subtracts batch means, so entries
# near 0 carry the f32 noise of the whole tensor: sav_tpu's own f32
# gradients of the small BoTNet sit up to 6e-5 of the largest entry from the
# port's f64 ones, on the CPU.
GRAD_RTOL, GRAD_ATOL_OF_LARGEST = 5e-3, 1e-4


def assert_grad_close(got, want, name):
    atol = GRAD_ATOL_OF_LARGEST * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)
# Every stage one block: the stem and stages 1-3 at full width, one BoTBlock
# attending over 4×4 (L = 16, 4 heads of 128) at 64².
SMALL = dict(stage_sizes=(1, 1, 1, 1))
IMAGE = 64


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy → the port's [N, C, H, W] channels_last view."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def draw_variables(variables, seed):
    """The head at std 0.05, every bn3 scale in [0.5, 1.5], every running
    mean in ±0.1 and variance in [0.5, 1.5], from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, variables["params"])
    params["head"]["kernel"] = rng.normal(0.0, 0.05, params["head"]["kernel"].shape).astype(np.float32)
    for name, block in params.items():
        if "block" in name:
            block["bn3"]["scale"] = rng.uniform(0.5, 1.5, block["bn3"]["scale"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.1, 0.1, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def jax_small_botnet(backend):
    return jax_create_model("botnet_t3", num_classes=10, dtype=jnp.float32, backend=backend, **SMALL)


def small_flax_variables(seed=0):
    """sav_tpu's init of the small BoTNet (jitted), with draw_variables."""
    model = jax_small_botnet("xla")
    init = jax.jit(lambda r: model.init({"params": r}, jnp.zeros((1, IMAGE, IMAGE, 3)),
                                        is_training=False))
    return draw_variables(init(jax.random.PRNGKey(seed)), seed + 1)


def small_port_model(variables, **kw):
    model = create_model("botnet_t3", num_classes=10, image_size=IMAGE, **SMALL, **kw)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def variables():
    return small_flax_variables()


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_botmhsa_matches_sav_tpu(backend):
    """Both backends against sav_tpu's BoTMHSA at the same backend (its
    Pallas relative kernel in interpret mode), on a 4×6 grid."""
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 32)).astype(np.float32)
    jax_block = JaxBoTMHSA(num_heads=4, backend=backend)
    init = jax.jit(lambda r: jax_block.init({"params": r}, x))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1))["params"])
    ref = np.asarray(jax.jit(lambda p: jax_block.apply({"params": p}, x))(params))
    block = BoTMHSA(32, 4, 4, 6, backend=backend)
    with torch.no_grad():
        for name in ("to_q", "to_k", "to_v"):
            getattr(block, name).copy_(torch.tensor(params[name]["kernel"]))
        for name in ("rel_emb_h", "rel_emb_w"):
            getattr(block, name).copy_(torch.tensor(params[name]))
    assert tuple(block.rel_emb_h.shape) == (7, 8) and tuple(block.rel_emb_w.shape) == (11, 8)
    out = block(_nchw(x))
    assert out.shape == (2, 32, 4, 6)
    np.testing.assert_allclose(_nhwc(out), ref, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="4x6 grid"):
        block(_nchw(x[:, :, :4]))


def test_botmhsa_rejects_an_unknown_backend():
    with pytest.raises(ValueError, match="unknown attention backend"):
        BoTMHSA(16, 2, 2, 2, backend="pallsa")(torch.zeros(1, 16, 2, 2))


def _flax_bn(x, stats, params, training, dtype=jnp.float32):
    bn = fnn.BatchNorm(use_running_average=not training, momentum=0.9, dtype=dtype)
    variables = {"params": params, "batch_stats": stats}
    if training:
        y, new = bn.apply(variables, jnp.asarray(x, dtype), mutable=["batch_stats"])
        return np.asarray(y, np.float32), jax.tree.map(np.asarray, new["batch_stats"])
    return np.asarray(bn.apply(variables, jnp.asarray(x, dtype)), np.float32), stats


def _bn_state_dict(params, stats):
    return {"weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"]),
            "running_mean": torch.from_numpy(stats["mean"]),
            "running_var": torch.from_numpy(stats["var"])}


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_flax(training):
    """Train mode: batch statistics, and the running ones updated with
    momentum 0.9 and the biased variance; eval mode: the running ones.
    2×2×2 positions per channel, where torch's unbiased running update
    would be off by 8/7 in the variance's step."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 2, 2, 6)) * 3 + 1).astype(np.float32)  # NHWC
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.1, 0.1, 6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    want, want_stats = _flax_bn(x, stats, params, training)
    bn = BatchNorm(6)
    bn.load_state_dict(_bn_state_dict(params, stats), strict=True)
    bn.train(training)
    got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_stats["mean"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_stats["var"], atol=1e-6, rtol=1e-6)
    if training:
        # torch's own running update (momentum 0.1 = flax's 0.9) uses the
        # unbiased variance and would not match.
        mean, var = torch.tensor(stats["mean"]), torch.tensor(stats["var"])
        F.batch_norm(_nchw(x), mean, var, training=True, momentum=0.1)
        np.testing.assert_allclose(mean.numpy(), want_stats["mean"], atol=1e-6, rtol=1e-6)
        assert np.abs(var.numpy() - want_stats["var"]).max() > 1e-2


def test_batch_norm_computes_in_f32_under_bf16():
    """bf16 in, bf16 out; statistics, scale and bias f32 (flax's dtype=bf16
    over f32 params)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 3, 3, 8)) * 2).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)}
    stats = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    want, want_stats = _flax_bn(np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), stats,
                                params, True, dtype=jnp.bfloat16)
    bn = BatchNorm(8)
    bn.load_state_dict(_bn_state_dict(params, stats))
    got = bn.train()(_nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got.float()), want, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(bn.running_var.numpy(), want_stats["var"], atol=1e-6, rtol=1e-5)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean", "running_var"}


@pytest.mark.parametrize(
    "size,kernel,stride,pads",
    [(224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)), (28, 3, 2, (0, 1)),
     (14, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1))],
)
def test_same_pads_are_flax_pads(size, kernel, stride, pads):
    assert same_pads(size, kernel, stride) == pads
    assert tuple(jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]) == pads


@pytest.mark.parametrize("size,kernel,stride,pool", [(32, 7, 2, False), (16, 3, 2, True),
                                                     (8, 3, 2, False), (8, 3, 1, False)])
def test_same_padding_matches_flax_and_symmetric_padding_does_not(size, kernel, stride, pool):
    """The stem conv (7×7/2: pads (2, 3)), the max pool (3×3/2, −inf pads
    (0, 1)) and a strided conv2 (3×3/2: (0, 1)) against flax's SAME; torch's
    symmetric ``padding=k//2`` gives the same shape with every window moved
    by a pixel, and is caught by value."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32) - 1.0  # mostly negative
    if pool:
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (kernel, kernel), (stride, stride), "SAME"))
        got = _nhwc(max_pool_same(_nchw(x), kernel, stride))
        symmetric = _nhwc(F.max_pool2d(_nchw(x), kernel, stride, kernel // 2))
    else:
        conv = fnn.Conv(5, (kernel, kernel), strides=(stride, stride), padding="SAME", use_bias=False)
        params = conv.init(jax.random.PRNGKey(0), x)
        want = np.asarray(conv.apply(params, x))
        layer = SameConv2d(4, 5, kernel, stride)
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1)))
            got = _nhwc(layer(_nchw(x)))
            symmetric = _nhwc(F.conv2d(_nchw(x), layer.weight, stride=stride, padding=kernel // 2))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert symmetric.shape == want.shape
    if stride == 2:
        assert not np.allclose(symmetric, want, atol=1e-2)


def test_squeeze_excite_matches_sav_tpu():
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 16)).astype(np.float32)
    jax_block = JaxSqueezeExcite(se_ratio=0.25)
    params = jax.tree.map(np.asarray, jax_block.init(jax.random.PRNGKey(2), x)["params"])
    params["reduce"]["bias"] = np.full(4, 0.1, np.float32)
    ref = np.asarray(jax_block.apply({"params": params}, x))
    block = SqueezeExciteBlock(16, 0.25)
    assert block.reduce.out_features == 4 and SqueezeExciteBlock(3, 0.25).reduce.out_features == 1
    with torch.no_grad():
        for name in ("reduce", "expand"):
            getattr(block, name).weight.copy_(torch.tensor(params[name]["kernel"].T))
            getattr(block, name).bias.copy_(torch.tensor(params[name]["bias"]))
    np.testing.assert_allclose(_nhwc(block(_nchw(x))), ref, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_small_botnet_eval_logits_match_sav_tpu(variables, backend):
    x = np.random.default_rng(6).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_small_botnet(backend)
    ref = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x, is_training=False))(variables, x))
    model = small_port_model(variables, backend=backend).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 0.5  # the drawn head and bn3 make the check non-vacuous
    np.testing.assert_allclose(out, ref, **TOL)


def test_small_botnet_train_mode_grads_and_batch_stats_match_sav_tpu(variables):
    """Train mode at the kernels' backend (the plain versions here, the
    Pallas kernels in interpret mode there): logits from batch statistics,
    every parameter's gradient of Σ logits², and the updated running
    statistics."""
    backend = "pallas"
    x = np.random.default_rng(7).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_small_botnet(backend)

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
    assert float(got["stage4_block0.mhsa.rel_emb_h"].abs().max()) > 1e-4
    for name, grad in got.items():
        assert_grad_close(grad.numpy(), want[name].numpy(), name)
    want_stats = params_from_flax({"params": variables["params"],
                                   "batch_stats": jax.tree.map(np.asarray, new_stats)})
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_zero_init_hides_the_trunk():
    """flax's init: every bn3 scale and the head are zero, so the logits are
    0 whatever the trunk computes: the checks above draw them."""
    model = create_model("botnet_t3", num_classes=10, image_size=IMAGE, **SMALL)
    bn3 = [m for name, m in model.named_modules() if name.endswith("bn3")]
    assert len(bn3) == 4 and all(torch.count_nonzero(m.weight) == 0 for m in bn3)
    assert torch.count_nonzero(model.head.weight) == 0
    x = torch.randn(2, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.count_nonzero(model.eval()(x)) == 0


# ------------------------------------------------------ interop, registry


def test_params_and_batch_stats_load_strictly(variables):
    state = params_from_flax(variables)
    assert state["stage4_block0.bn2.running_var"].shape == (512,)
    assert state["stem_conv.weight"].shape == (64, 3, 7, 7)  # HWIO → OIHW
    assert state["stage1_block0.se.reduce.weight"].shape == (16, 64)  # [in, out] → [out, in]
    assert state["stage4_block0.mhsa.to_q"].shape == (1024 // 2, 4, 128)
    model = small_port_model(variables)
    np.testing.assert_array_equal(model.stem_bn.running_mean.numpy(),
                                  variables["batch_stats"]["stem_bn"]["mean"])
    with pytest.raises(RuntimeError, match="running_mean"):  # params alone: no statistics
        create_model("botnet_t3", num_classes=10, image_size=IMAGE, **SMALL).load_state_dict(
            params_from_flax(variables["params"]), strict=True)
    bad = {"params": variables["params"],
           "batch_stats": {**variables["batch_stats"], "stem_bn": {
               **variables["batch_stats"]["stem_bn"], "count": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="BoTNet port does not consume.*batch_stats/stem_bn/count"):
        params_from_flax(bad)
    bad_params = {**variables["params"], "stage1_block0": {
        **variables["params"]["stage1_block0"], "Dropout_0": {"rate": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="Dropout_0"):
        params_from_flax({"params": bad_params, "batch_stats": variables["batch_stats"]})


def test_botnet_t3_state_dict_matches_flax_tree_at_full_size():
    jax_model = jax_create_model("botnet_t3", num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    converted = params_from_flax(tree)
    ours = create_model("botnet_t3").state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert tuple(ours["stage4_block0.mhsa.rel_emb_h"].shape) == (27, 128)  # 14×14 grid
    assert tuple(ours["stage4_block5.mhsa.rel_emb_w"].shape) == (13, 128)  # 7×7 grid


def test_registry_names():
    for name in ("botnet_t3", "botnet_t4", "botnet_t5"):
        assert name in model_names()
        assert JAX_REGISTRY[name][1]["stage_sizes"] == registry._BOTNET[name]
        small = create_model(name, num_classes=10, image_size=IMAGE, stage_sizes=(1, 0, 1, 2))
        assert isinstance(small, BoTNet) and small.block_names == [
            "stage1_block0", "stage3_block0", "stage4_block0", "stage4_block1"]
    t3 = create_model("botnet_t3")
    assert t3.stage_sizes == (3, 4, 6, 6) and len(t3.block_names) == 19
    assert [t3.get_submodule(f"stage4_block{i}").mhsa.height for i in range(6)] == [14] + [7] * 5
    assert attention_grids(224, (3, 4, 6, 6)) == [(14, 14)] + [(7, 7)] * 5
    assert attention_grids(64, (1, 1, 1, 1)) == [(4, 4)]


def test_weight_decay_mask_on_the_botnet_tree_matches_sav_tpu(variables):
    """By flax path and by port name the same leaves decay: conv kernels
    (rank 4), SE and head kernels and the q/k/v projections do; the
    relative tables (by name), BatchNorm scales and biases and the Dense
    biases (rank 1) do not."""
    params = variables["params"]
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("botnet_t3", num_classes=10, image_size=IMAGE, **SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["stem_conv.weight"] and got["stage1_block0.se.reduce.weight"]
    assert got["stage4_block0.mhsa.to_q"] and got["head.weight"]
    assert not got["stage4_block0.mhsa.rel_emb_h"] and not got["stage4_block0.mhsa.rel_emb_w"]
    assert not got["stage1_block0.bn3.weight"] and not got["stage1_block0.se.reduce.bias"]
