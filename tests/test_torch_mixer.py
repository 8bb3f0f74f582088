"""The port's MLP-Mixer (sav_tpu_torch.models.mlp_mixer) against sav_tpu's, on
the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs. The family has no
attention, so no kernel runs on either side; the backends are the same
model. The head starts at zero, so the tests draw it first. Tolerances are
tests/test_models.py's: f32 atol 1e-4, rtol 5e-3 on logits; gradients atol
1e-4 of each tensor's largest entry, rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.mlp_mixer import MixerBlock as JaxMixerBlock
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names, registry
from sav_tpu_torch.models.mlp_mixer import MixerBlock, MLPMixer, mean_tokens
from sav_tpu_torch.models.layers import set_dropout_generator
from sav_tpu_torch.train import optimizer as port_optimizer

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=5e-3)
GRAD_RTOL, GRAD_ATOL_OF_LARGEST = 5e-3, 1e-4
# embed 32, 2 layers, token MLP 16 wide, channel MLP 64 wide; 8×8 patches of
# a 32² image: 16 tokens.
SMALL = dict(embed_dim=32, num_layers=2, tokens_hidden_ch=16, channels_hidden_ch=64,
             patch_shape=(8, 8))
IMAGE = 32
MIXER_NAMES = tuple(f"mixer_{s}_patch{p}" for s in "sbl" for p in (32, 16))


def assert_grad_close(got, want, name):
    atol = GRAD_ATOL_OF_LARGEST * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def init_flax(module, *args, seed=0, **kw):
    init = jax.jit(lambda r: module.init({"params": r}, *args, **kw))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def jax_small_mixer(**kw):
    return jax_create_model("mixer_s_patch16", num_classes=10, dtype=jnp.float32, **SMALL, **kw)


def small_flax_params(seed=0):
    """sav_tpu's init of the small Mixer, the zero head drawn at std 0.05."""
    params = init_flax(jax_small_mixer(), jnp.zeros((1, IMAGE, IMAGE, 3)), is_training=False,
                       seed=seed)["params"]
    rng = np.random.default_rng(seed + 1)
    params["head"]["kernel"] = rng.normal(0.0, 0.05, params["head"]["kernel"].shape).astype(
        np.float32)
    return params


def small_port_model(params, **kw):
    model = create_model("mixer_s_patch16", num_classes=10, image_size=IMAGE, **SMALL, **kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def block_state(tree):
    """The port's MixerBlock state from a flax tree ``{"block_0": ...}``."""
    return {k.removeprefix("blocks.0."): v for k, v in params_from_flax(tree).items()}


@pytest.fixture(scope="module")
def params():
    return small_flax_params()


# ------------------------------------------------------------------ layers


def test_mixer_block_matches_sav_tpu_with_gradients():
    """Token mixing across the 16 tokens on the transposed view, channel
    mixing across the 32 channels: the output and every gradient of Σ out²."""
    x = np.random.default_rng(2).standard_normal((3, 16, 32)).astype(np.float32)
    jax_block = JaxMixerBlock(tokens_hidden_ch=8, channels_hidden_ch=64)
    block_params = init_flax(jax_block, x, is_training=False)["params"]

    def jax_loss(p, x):
        out = jax_block.apply({"params": p}, x, is_training=False)
        return jnp.sum(out ** 2), out

    (_, want), (grads, dx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        block_params, x)
    block = MixerBlock(16, 32, 8, 64)
    block.load_state_dict(block_state({"block_0": block_params}), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = block(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    (got ** 2).sum().backward()
    assert_grad_close(xt.grad.numpy(), np.asarray(dx), "inputs")
    want_grads = block_state({"block_0": jax.tree.map(np.asarray, grads)})
    for name, p in block.named_parameters():
        assert_grad_close(p.grad.numpy(), want_grads[name].numpy(), name)


def test_token_mixing_reads_the_transposed_view():
    """The token-mixing MLP's input is a non-contiguous [B, D, L] view of the
    LayerNorm'd tokens, and it mixes across L: permuting the tokens of the
    input without permuting the MLP's weights changes the output of other
    tokens (a channel-only MLP would only permute it)."""
    block = MixerBlock(16, 32, 8, 64)
    block.load_state_dict(
        {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, v) in enumerate(block.state_dict().items())})
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(9))
    seen = []
    hook = block.token_mixing.fc1.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        out = block(x)
        perm = torch.arange(15, -1, -1)
        permuted = block(x[:, perm])
    hook.remove()
    assert seen[0].shape == (2, 32, 16) and not seen[0].is_contiguous()
    assert not torch.allclose(permuted, out[:, perm], atol=1e-3)


def test_bf16_pooled_features_are_jnp_mean():
    """jnp.mean of a bf16 array sums in f32 and casts the mean back; the
    port's pooling does the same (a mean summed in bf16 would not)."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((8, 196, 64)) + 3.0, jnp.bfloat16)
    want = np.asarray(jnp.mean(x, axis=1)).astype(np.float32)
    xt = torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16()
    got = mean_tokens(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    summed_in_bf16 = torch.zeros(8, 64, dtype=torch.bfloat16)
    for i in range(196):
        summed_in_bf16 = summed_in_bf16 + xt[:, i]
    assert not np.array_equal((summed_in_bf16 / 196).float().numpy(), want)


def test_bf16_logits_match_sav_tpu(params):
    """The small Mixer in bf16 on both sides (f32 parameters cast at use):
    sav_tpu's tests/test_models.py bf16 tolerance, 3e-2."""
    x = np.random.default_rng(5).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_create_model("mixer_s_patch16", num_classes=10, dtype=jnp.bfloat16, **SMALL)
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                                     is_training=False), np.float32)
    model = small_port_model(params)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=3e-2)


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_small_mixer_logits_and_grads_match_sav_tpu(params, backend):
    """Logits and every gradient of Σ logits², at each backend (sav_tpu's
    create_model drops the backend for an attention-free family, as the
    port's does: no kernel runs on either side)."""
    x = np.random.default_rng(6).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    jax_model = jax_create_model("mixer_s_patch16", num_classes=10, dtype=jnp.float32,
                                 backend=backend, **SMALL)

    def loss(p):
        logits = jax_model.apply({"params": p}, x, is_training=False)
        return jnp.sum(logits ** 2), logits

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = small_port_model(params, backend=backend)
    logits = model(torch.from_numpy(x))
    (logits ** 2).sum().backward()
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), **TOL)
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    assert float(got["blocks.0.token_mixing.fc1.weight"].abs().max()) > 1e-4
    for name, grad in got.items():
        assert_grad_close(grad.numpy(), want[name].numpy(), name)


def test_four_mixer_train_steps_match_sav_tpu():
    """The Mixer slice as a whole: 4 f32 steps of the small Mixer through
    sav_tpu's Trainer and the port's (see tests/test_torch_train.py). The
    token-mixing fc2 bias adds one constant to every channel of a token in
    the residual stream, which each later LayerNorm (over the channels)
    subtracts again: its gradient is 0 in exact arithmetic and f32 noise on
    both sides (shown here), so its value after Adam is noise and is held
    near 0 instead of compared, as CeiT's LeFF biases are."""
    from test_torch_train import _four_steps_against_sav_tpu

    params = small_flax_params(seed=3)
    zero_grad = tuple(f"blocks.{i}.token_mixing.fc2.bias" for i in range(SMALL["num_layers"]))
    model = small_port_model(params)
    x = np.random.default_rng(12).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    largest = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        assert (float(p.grad.abs().max()) < 1e-6 * largest) == (name in zero_grad), name
    _four_steps_against_sav_tpu("mixer_s_patch16", SMALL, params, backend=None,
                                image_size=IMAGE, zero_grad_params=zero_grad)


def test_dropout_sites_and_zero_head():
    """Two Dropout layers in each FF block, two FF blocks a layer, as flax's
    nn.Dropout sites; the zero-init head makes every logit 0."""
    model = create_model("mixer_s_patch16", num_classes=10, image_size=IMAGE, dropout_rate=0.1,
                         **SMALL)
    assert set_dropout_generator(model, torch.Generator().manual_seed(0)) == 2 * 2 * 2
    assert torch.count_nonzero(model.head.weight) == 0
    with torch.no_grad():
        assert torch.count_nonzero(model.eval()(torch.randn(2, IMAGE, IMAGE, 3))) == 0


# ------------------------------------------------------ interop, registry


def test_interop_round_trip_is_exact(params):
    state = params_from_flax(params)
    assert state["blocks.0.token_mixing.fc1.weight"].shape == (16, 16)  # [hidden, tokens]
    assert state["blocks.0.channel_mixing.fc1.weight"].shape == (64, 32)
    back = flax_from_params(state, "MLPMixer")
    flat = jax.tree_util.tree_flatten_with_path(back["params"])[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(back) == {"params"} and len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    bad = {**params, "block_0": {**params["block_0"], "Dropout_0": {"rate": np.zeros(1)}}}
    with pytest.raises(KeyError, match="MLPMixer port does not consume.*Dropout_0"):
        params_from_flax(bad)


@pytest.mark.parametrize("name", MIXER_NAMES)
def test_registry_entry_matches_sav_tpu_tree_at_full_size(name):
    """Built on the meta device at 224², every port tensor has the shape the
    sav_tpu tree converts to, and the config fields are sav_tpu's."""
    fields = JAX_REGISTRY[name][1]
    embed_dim, num_layers, tokens_ch, channels_ch, patch = registry._MIXER[name]
    assert (fields["embed_dim"], fields["num_layers"], fields["tokens_hidden_ch"],
            fields["channels_hidden_ch"], fields["patch_shape"]) == (
        embed_dim, num_layers, tokens_ch, channels_ch, (patch, patch))
    jax_model = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = MLPMixer(1000, embed_dim, num_layers, tokens_ch, channels_ch, (patch, patch))
    ours = ours.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    assert name in model_names()


def test_registry_refuses_unported_options():
    with pytest.raises(ValueError, match="not divisible"):
        create_model("mixer_s_patch16", image_size=40)


def test_weight_decay_mask_on_the_mixer_tree_matches_sav_tpu(params):
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("mixer_s_patch16", num_classes=10, image_size=IMAGE, **SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["blocks.0.token_mixing.fc1.weight"] and not got["blocks.0.norm1.weight"]
