"""The port's CeiT (sav_tpu_torch.models.ceit and its layers: DepthwiseConv2D,
Image2TokenBlock, LeFFBlock, LCSelfAttentionBlock) against sav_tpu's, on the
CPU.

Both sides take the same flax variables (the port's through
``params_from_flax``, ``batch_stats`` included) and the same numpy inputs;
sav_tpu runs its Pallas kernels in interpret mode, the port the kernels'
plain versions. The head starts at zero and the running statistics at 0/1,
so the tests draw them first. Tolerances are tests/test_models.py's and
tests/test_torch_botnet.py's: f32 atol 1e-4, rtol 5e-3; gradients atol 1e-4
of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers import Image2TokenBlock as JaxImage2TokenBlock
from sav_tpu.models.layers import LCSelfAttentionBlock as JaxLCSelfAttentionBlock
from sav_tpu.models.layers import LeFFBlock as JaxLeFFBlock
from sav_tpu.models.layers.depthwise import DepthwiseConv2D as JaxDepthwiseConv2D
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names, registry
from sav_tpu_torch.models.ceit import CeiT, token_grid
from sav_tpu_torch.models.layers import (
    DepthwiseConv2D,
    Image2TokenBlock,
    LCSelfAttentionBlock,
    LeFFBlock,
    cast_for_compute,
)
from sav_tpu_torch.train import optimizer as port_optimizer

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=5e-3)
GRAD_RTOL, GRAD_ATOL_OF_LARGEST = 5e-3, 1e-4
# embed 32, 2 layers, 2 heads of 16 at 32²: the stem gives 8×8, 4×4 patches
# 2×2 tokens (L = 5 with CLS); the class attention one query over 2 tokens.
SMALL = dict(embed_dim=32, num_layers=2, num_heads=2)
IMAGE = 32
CEIT_NAMES = ("ceit_t", "ceit_s", "ceit_b")


def assert_grad_close(got, want, name):
    atol = GRAD_ATOL_OF_LARGEST * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def draw_variables(variables, seed):
    """The head at std 0.05, every running mean in ±0.1 and variance in
    [0.5, 1.5], from a numpy seed (the zero head would hide every logit and
    gradient, statistics at 0/1 an eval path that skipped them)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, variables["params"])
    params["head"]["kernel"] = rng.normal(0.0, 0.05, params["head"]["kernel"].shape).astype(np.float32)
    return {"params": params, "batch_stats": draw_stats(variables["batch_stats"], rng)}


def draw_stats(stats, rng):
    """Running means in ±0.1 and variances in [0.5, 1.5] from ``rng``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.1, 0.1, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), stats)


def init_flax(module, *args, seed=0, **kw):
    """A flax module's variables as numpy, from a jitted init."""
    init = jax.jit(lambda r: module.init({"params": r}, *args, **kw))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def flax_train_forward(module, variables, *args):
    """Train-mode apply: outputs and the updated batch_stats, as numpy."""
    out, new = module.apply(variables, *args, is_training=True, mutable=["batch_stats"])
    return np.asarray(out), jax.tree.map(np.asarray, new["batch_stats"])


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()},
                           strict=True)
    return module


def bn_state(prefix, params, stats):
    return {f"{prefix}weight": params["scale"], f"{prefix}bias": params["bias"],
            f"{prefix}running_mean": stats["mean"], f"{prefix}running_var": stats["var"]}


def jax_small_ceit(backend):
    return jax_create_model("ceit_s", num_classes=10, dtype=jnp.float32, backend=backend, **SMALL)


def small_flax_variables(seed=0):
    """sav_tpu's init of the small CeiT, with draw_variables."""
    variables = init_flax(jax_small_ceit("xla"), jnp.zeros((1, IMAGE, IMAGE, 3)),
                          is_training=False, seed=seed)
    return draw_variables(variables, seed + 1)


def small_port_model(variables, **kw):
    model = create_model("ceit_s", num_classes=10, image_size=IMAGE, **SMALL, **kw)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def variables():
    return small_flax_variables()


# -------------------------------------------------------------- depthwise


def _depthwise_pair(channels, kernel, stride, seed):
    jax_conv = JaxDepthwiseConv2D(features=channels, kernel_size=(kernel, kernel), stride=stride)
    x = np.zeros((1, 5, 5, channels), np.float32)
    params = init_flax(jax_conv, x, seed=seed)["params"]
    conv = DepthwiseConv2D(channels, (kernel, kernel), stride)
    load(conv, {"weight": params["kernel"].transpose(3, 2, 0, 1)})
    return jax_conv, params, conv


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 1), (7, 3, 1), (8, 3, 2), (7, 3, 2),
                                                (14, 5, 1), (9, 5, 2)])
def test_depthwise_matches_sav_tpu(size, kernel, stride):
    """Stride 1 and 2 on even and odd grids (SAME pads (0, 1) at stride 2 on
    an even grid, (1, 1) on an odd one), 3×3 and LeFF's 5×5."""
    x = np.random.default_rng(0).standard_normal((2, size, size, 6)).astype(np.float32)
    jax_conv, params, conv = _depthwise_pair(6, kernel, stride, seed=1)
    want = np.asarray(jax_conv.apply({"params": params}, x))
    got = conv(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, -(-size // stride), -(-size // stride), 6)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-5)


def test_depthwise_multiplies_by_the_f32_kernel_under_bf16():
    """bf16 taps times the f32 kernel, summed in f32 and cast once: the
    port's bf16 output is sav_tpu's, but where the f32 sums, taken in
    another order, round to either side of a bf16 boundary (one ulp at
    most; none at this seed). Rounding the kernel to bf16, as
    ``nn.Conv(dtype=bf16)`` would, moves about 40 % of the outputs by an
    ulp: the check fails on that."""
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(rng.standard_normal((4, 8, 8, 16)), jnp.bfloat16))
    jax_conv = JaxDepthwiseConv2D(features=16, kernel_size=(3, 3), stride=1, dtype=jnp.bfloat16)
    kernel = (rng.standard_normal((3, 3, 1, 16)) / 3.0).astype(np.float32)
    want = np.asarray(jax_conv.apply({"params": {"kernel": kernel}}, x)).astype(np.float32)
    conv = load(DepthwiseConv2D(16, (3, 3), 1), {"weight": kernel.transpose(3, 2, 0, 1)})
    cast_for_compute(conv, torch.bfloat16)
    assert conv.weight.dtype == torch.float32  # F32_TENSORS
    xt = torch.from_numpy(x.astype(np.float32)).bfloat16()
    with torch.no_grad():
        got = conv(xt)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        # One bf16 ulp of the larger, or f32 rounding of the taps' sum where
        # it cancels to about 0.
        ulp = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7 + 1e-6
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got != want) < 1e-3
        rounded = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xt.permute(0, 3, 1, 2).float(), (1, 1, 1, 1)),
            conv.weight.bfloat16().float(), groups=16).bfloat16().float().permute(0, 2, 3, 1)
    assert np.mean(rounded.numpy() != want) > 0.2


# ------------------------------------------------------------------ stem


@pytest.mark.parametrize("training", [True, False])
def test_image2token_matches_sav_tpu(training):
    """7×7/2 conv (pads (2, 3)), BatchNorm, 3×3/2 max pool (−inf pads (0,
    1)) and patches: 36² → 18² → 9², 3×3 patches give 3×3 tokens; train
    mode also the updated running statistics."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 36, 36, 3)).astype(np.float32)
    jax_stem = JaxImage2TokenBlock(patch_shape=(3, 3), embed_dim=8, stem_ch=6)
    raw = init_flax(jax_stem, x, is_training=False)
    params = raw["params"]
    variables = {"params": params, "batch_stats": draw_stats(raw["batch_stats"], rng)}
    stem = Image2TokenBlock((3, 3), 8, stem_ch=6)
    load(stem, {"stem_conv.weight": params["stem_conv"]["kernel"].transpose(3, 2, 0, 1),
                **bn_state("stem_bn.", params["stem_bn"], variables["batch_stats"]["stem_bn"]),
                "patch_embed.proj.weight": params["patch_embed"]["proj"]["kernel"].transpose(3, 2, 0, 1),
                "patch_embed.proj.bias": params["patch_embed"]["proj"]["bias"]})
    if training:
        want, stats = flax_train_forward(jax_stem, variables, x)
    else:
        want = np.asarray(jax_stem.apply(variables, x, is_training=False))
        stats = variables["batch_stats"]
    got = stem.train(training)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 9, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(stem.stem_bn.running_mean.numpy(), stats["stem_bn"]["mean"],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(stem.stem_bn.running_var.numpy(), stats["stem_bn"]["var"],
                               atol=1e-6, rtol=1e-5)


def test_token_grid_follows_the_stem():
    assert token_grid(224, (4, 4)) == 14 and token_grid(32, (4, 4)) == 2
    assert token_grid(36, (3, 3)) == 3
    with pytest.raises(ValueError, match="not divisible"):
        token_grid(40, (4, 4))


# ------------------------------------------------------------------- LeFF


def _leff_state(params, stats):
    state = {f"{n}.weight": params[n]["kernel"].T for n in ("expand", "project")}
    state.update({f"{n}.bias": params[n]["bias"] for n in ("expand", "project")})
    state["dwconv.weight"] = params["dwconv"]["kernel"].transpose(3, 2, 0, 1)
    for n in ("bn1", "bn2", "bn3"):
        state.update(bn_state(f"{n}.", params[n], stats[n]))
    return state


@pytest.mark.parametrize("training", [True, False])
def test_leff_matches_sav_tpu(training):
    """CLS split off and joined back untouched, expand/BN/GELU, the 5×5
    depthwise conv on the 5×5 grid, BN/GELU, project/BN/GELU; each
    BatchNorm over batch and tokens; train mode also the running
    statistics and every gradient of Σ out²."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 26, 8)).astype(np.float32)
    jax_leff = JaxLeFFBlock(expand_ratio=2.0)
    raw = init_flax(jax_leff, x, is_training=False)
    variables = {"params": raw["params"], "batch_stats": draw_stats(raw["batch_stats"], rng)}
    leff = load(LeFFBlock(8, expand_ratio=2.0),
                _leff_state(variables["params"], variables["batch_stats"])).train(training)
    xt = torch.from_numpy(x).requires_grad_()
    got = leff(xt)
    if training:
        def jax_loss(params, x):
            out, new = jax_leff.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      x, is_training=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, new["batch_stats"])

        (_, (want, stats)), (grads, dx) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                             has_aux=True)(variables["params"], x)
        stats = jax.tree.map(np.asarray, stats)
        (got ** 2).sum().backward()
        assert_grad_close(xt.grad.numpy(), np.asarray(dx), "inputs")
        want_grads = _leff_state(jax.tree.map(np.asarray, grads), stats)
        for name, p in leff.named_parameters():
            assert_grad_close(p.grad.numpy(), want_grads[name], name)
        for n in ("bn1", "bn2", "bn3"):
            bn = getattr(leff, n)
            np.testing.assert_allclose(bn.running_mean.numpy(), stats[n]["mean"], atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), stats[n]["var"], atol=1e-6, rtol=1e-5)
    else:
        want = jax_leff.apply(variables, x, is_training=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.detach().numpy()[:, 0], x[:, 0])


def test_leff_refuses_a_grid_that_is_not_square():
    with pytest.raises(ValueError, match="square token grid"):
        LeFFBlock(8)(torch.zeros(1, 1 + 6, 8))


# ----------------------------------------------------- class attention


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_lc_attention_matches_sav_tpu(backend):
    """The last token attends over all 12 (CeiT-S's shape, narrower), at
    both backends (sav_tpu's fused Pallas kernel in interpret mode)."""
    x = np.random.default_rng(7).standard_normal((3, 12, 32)).astype(np.float32)
    jax_block = JaxLCSelfAttentionBlock(num_heads=2, backend=backend)
    params = init_flax(jax_block, x, is_training=False)["params"]
    want = np.asarray(jax_block.apply({"params": params}, x, is_training=False))
    block = load(LCSelfAttentionBlock(32, 2, backend=backend),
                 {f"to_{n}": params[f"to_{n}"]["kernel"] for n in ("q", "k", "v", "out")})
    got = block(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (3, 1, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=2e-5)
    # The query is the last token: changing the first moves K/V only.
    assert not np.allclose(block(torch.from_numpy(x[:, ::-1].copy())).detach().numpy(), want)


# ------------------------------------------------------------------ model


def test_zero_head_hides_the_trunk():
    model = create_model("ceit_s", num_classes=10, image_size=IMAGE, **SMALL)
    assert torch.count_nonzero(model.head.weight) == 0 and torch.count_nonzero(model.cls) == 0
    x = torch.randn(2, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.count_nonzero(model.eval()(x)) == 0


# ------------------------------------------------------ interop, registry


def test_interop_round_trip_is_exact(variables):
    state = params_from_flax(variables)
    assert state["blocks.0.leff.dwconv.weight"].shape == (128, 1, 5, 5)  # [kh, kw, 1, C] → [C, 1, kh, kw]
    assert state["stem.stem_conv.weight"].shape == (32, 3, 7, 7)
    assert state["lca.to_q"].shape == (32, 2, 16)
    back = flax_from_params(state, "CeiT")
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    with pytest.raises(RuntimeError, match="running_mean"):  # params alone: no statistics
        create_model("ceit_s", num_classes=10, image_size=IMAGE, **SMALL).load_state_dict(
            params_from_flax(variables["params"]), strict=True)
    bad = {**variables["params"], "block_0": {**variables["params"]["block_0"],
                                              "Dropout_0": {"rate": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="CeiT port does not consume.*Dropout_0"):
        params_from_flax({"params": bad, "batch_stats": variables["batch_stats"]})


@pytest.mark.parametrize("name", CEIT_NAMES)
def test_registry_entry_matches_sav_tpu_tree_at_full_size(name):
    """Built on the meta device, every port tensor has the shape the
    sav_tpu tree converts to, and the config fields are sav_tpu's."""
    fields = JAX_REGISTRY[name][1]
    assert (fields["embed_dim"], fields["num_layers"], fields["num_heads"]) == registry._CEIT[name]
    assert fields["patch_shape"] == (4, 4)
    jax_model = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = CeiT(1000, fields["embed_dim"], fields["num_layers"], fields["num_heads"], (4, 4))
    ours = ours.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert name in model_names()


def test_registry_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="A9"):
        create_model("ceit_s", seq_parallel="ring")


def test_weight_decay_mask_on_the_ceit_tree_matches_sav_tpu(variables):
    params = variables["params"]
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("ceit_s", num_classes=10, image_size=IMAGE, **SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["blocks.0.leff.dwconv.weight"] and got["stem.stem_conv.weight"]
    assert not got["cls"] and not got["pos_embed.pos_embed"] and not got["blocks.0.leff.bn1.weight"]
