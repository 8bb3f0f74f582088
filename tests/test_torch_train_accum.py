"""Gradient accumulation, evaluation, dropout, presets and the train CLI of
the port (sav_tpu_torch.train, sav_tpu_torch.models.layers) against
sav_tpu's, on the CPU.

Tolerances are PERF.md §2's CPU row: loss 1e-5, grad norm and lr 1e-4
relative, parameters and statistics 2e-5 / 1e-4 (tests/test_torch_train.py's
four-step helper). Both sides run the dense attention paths here (backend
'xla'), so no Pallas kernel needs interpret mode; the kernels' plain
versions are held against sav_tpu in their own test files.
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from sav_tpu.train.config import TrainConfig as JaxTrainConfig
from sav_tpu.train.presets import get_preset as jax_get_preset
from sav_tpu.train.presets import preset_names as jax_preset_names
from sav_tpu.train.trainer import Trainer as JaxTrainer
from sav_tpu_torch.data.synthetic import synthetic_data_iterator
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models import vit as port_vit
from sav_tpu_torch.models.layers import (
    AttentionBlock,
    Dropout,
    set_dropout_generator,
)
from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.ops import fused_attention as port_fused
from sav_tpu_torch.ops import talking_heads as port_th
from sav_tpu_torch.train import TrainConfig, Trainer, get_preset, main, preset_names
from sav_tpu_torch.utils.metrics import cross_entropy
from test_torch_train import SMALL, _flax_params, _four_steps_against_sav_tpu

torch.set_num_threads(2)


# ---------------------------------------------------------- accumulation


def test_accumulated_vit_steps_match_sav_tpu():
    """4 steps of the small ViT at global batch 16 as 2 micro-batches of 8:
    loss, grad norm and lr per step, then every parameter, against
    sav_tpu's scan over micro-batches."""
    _four_steps_against_sav_tpu("vit_ti_patch16", SMALL, _flax_params(), backend="xla",
                                grad_accum_steps=2)


def test_accumulation_is_the_mean_of_its_micro_batches():
    """One accumulated step's loss and gradients are the micro-batches'
    means: against two plain steps' forward and backward at lr 0 on the
    same halves (the update and the statistics apart)."""
    batch = next(synthetic_data_iterator(batch_size=16, image_size=32, num_classes=10, seed=2))
    common = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                  compute_dtype="float32", global_batch_size=16, transpose_images=False,
                  model_overrides=dict(SMALL), clip_grad_norm=None)
    accum = Trainer(TrainConfig(grad_accum_steps=2, **common), device="cpu")
    state = accum.init_state()
    params = [p.detach().clone() for p in state.model.parameters()]
    _, metrics = accum.train_step(state, batch)
    plain = Trainer(TrainConfig(**common), device="cpu")
    model = plain.init_state().model
    losses, grads = [], []
    for half in (slice(0, 8), slice(8, 16)):
        probs = plain._label_probs({}, torch.as_tensor(batch["labels"][half]).long())
        loss = cross_entropy(model(torch.from_numpy(batch["images"][half])), probs)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
    np.testing.assert_allclose(float(metrics["loss"]), float(sum(losses) / 2), rtol=1e-6)
    mean = [(a + b) / 2 for a, b in zip(*grads)]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in mean]))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(norm), rtol=1e-5)


def test_an_indivisible_batch_raises_as_sav_tpu_does():
    trainer = Trainer(TrainConfig(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                                  compute_dtype="float32", global_batch_size=16,
                                  transpose_images=False, model_overrides=dict(SMALL),
                                  grad_accum_steps=3), device="cpu")
    batch = next(synthetic_data_iterator(batch_size=16, image_size=32, num_classes=10))
    with pytest.raises(ValueError, match="batch size 16 not divisible by grad_accum_steps 3"):
        trainer.train_step(trainer.init_state(), batch)


# ------------------------------------------------------------ evaluation


def _pair(**config):
    """sav_tpu's Trainer and the port's from one parameter tree (dense
    attention on both sides)."""
    common = dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                  compute_dtype="float32", attention_backend="xla", model_overrides=dict(SMALL),
                  global_batch_size=16, num_train_images=48, num_epochs=3, warmup_epochs=0,
                  transpose_images=False, base_lr=0.05, seed=0, **config)
    params = _flax_params(head_std=0.5)
    jax_trainer = JaxTrainer(JaxTrainConfig(**common))
    jstate = jax_trainer.init_state()
    jstate = jstate.replace(params=jax.tree.map(
        lambda n, o: jax.device_put(n, o.sharding), params, jstate.params))
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, backend="xla", **SMALL)
    model.load_state_dict(params_from_flax(params), strict=True)
    trainer = Trainer(TrainConfig(**common), model=model, device="cpu")
    return jax_trainer, jstate, trainer, trainer.init_state()


def _eval_batches():
    """Two batches of 16 and a short one of 5: the last is padded."""
    big = list(synthetic_data_iterator(batch_size=16, image_size=32, num_classes=10, seed=21,
                                       num_batches=3))
    big[-1] = {k: v[:5] for k, v in big[-1].items()}
    return big


def test_evaluate_pads_a_short_last_batch_as_sav_tpu():
    jax_trainer, jstate, trainer, state = _pair()
    ref = jax_trainer.evaluate(jstate, iter(_eval_batches()))
    got = trainer.evaluate(state, iter(_eval_batches()))
    assert set(got) == set(ref) and got["eval_count"] == ref["eval_count"] == 37.0
    for key in ("eval_loss", "eval_top_1_acc", "eval_top_5_acc"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-6, err_msg=key)
    padded = trainer._pad_eval_batch(_eval_batches()[-1], 16)
    assert padded["images"].shape == (16, 32, 32, 3) and padded["valid"].tolist() == [1.0] * 5 + [0.0] * 11
    assert not padded["images"][5:].any()
    tensors = {k: torch.from_numpy(v) for k, v in _eval_batches()[-1].items()}
    assert trainer._pad_eval_batch(tensors, 16)["images"].shape == (16, 32, 32, 3)


def test_fit_evaluates_at_sav_tpu_steps():
    """3-step epochs, eval every epoch, 7 steps: eval records at steps 3 and
    6 on both sides, each also passed to log_fn."""
    jax_trainer, jstate, trainer, state = _pair(eval_every_epochs=1, log_every_steps=2)
    batches = list(synthetic_data_iterator(batch_size=16, image_size=32, num_classes=10, seed=11,
                                           num_batches=7))
    _, jax_history = jax_trainer.fit(iter(batches), num_steps=7, state=jstate,
                                     eval_iter_fn=lambda: iter(_eval_batches()))
    logged = []
    _, history = trainer.fit(iter(batches), num_steps=7, state=state, log_fn=logged.append,
                             eval_iter_fn=lambda: iter(_eval_batches()))
    want = [r for r in jax_history if "eval_loss" in r]
    got = [r for r in history if "eval_loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 6]
    assert [r for r in logged if "eval_loss" in r] == got
    for ours, ref in zip(got, want):
        assert ours["eval_count"] == ref["eval_count"] == 37.0
        np.testing.assert_allclose(ours["eval_loss"], ref["eval_loss"], rtol=1e-4)
    assert [r["step"] for r in history if "loss" in r] == list(range(1, 8))


# ---------------------------------------------------------------- dropout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_flax_dropout_under_its_mask(dtype):
    """flax's nn.Dropout keeps ``x / keep`` where its mask is set: the port's
    apply_mask under the mask flax drew gives the same bits."""
    x = np.random.default_rng(0).uniform(0.5, 2.0, (4, 9, 16)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = fnn.Dropout(rate=0.3).apply({}, jx, deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(3)})
    ref = np.asarray(ref.astype(jnp.float32))
    mask = torch.from_numpy(ref != 0)
    assert 0 < mask.float().mean() < 1
    layer = Dropout(0.3)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layer.apply_mask(tx, mask)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(layer.eval()(tx), tx) and torch.equal(Dropout(0.0).train()(tx), tx)
    with pytest.raises(RuntimeError, match="explicit generator"):
        layer.train()(tx)
    layer.generator = torch.Generator().manual_seed(0)
    kept = (layer(torch.ones(100_000)) != 0).float().mean().item()
    assert abs(kept - 0.7) < 5 * (0.7 * 0.3 / 100_000) ** 0.5


def test_vit_at_rate_zero_equals_sav_tpu_in_training():
    from test_torch_vit import SMALL as VIT_SMALL
    from test_torch_vit import small_flax_params

    params = small_flax_params()
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    rates = dict(dropout_rate=0.0, attn_dropout_rate=0.0)
    jax_model = jax_create_model("vit_ti_patch16", num_classes=10, dtype=jnp.float32,
                                 backend="xla", **VIT_SMALL, **rates)
    ref = np.asarray(jax_model.apply({"params": params}, x, is_training=True,
                                     rngs={"dropout": jax.random.PRNGKey(0)}))
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, backend="xla",
                         **VIT_SMALL, **rates)
    model.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _remat_grads(remat, block_fn=None):
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, remat=remat,
                         dropout_rate=0.2, attn_dropout_rate=0.2, **SMALL)
    with torch.no_grad():
        torch.nn.init.normal_(model.head.weight, std=0.5, generator=torch.Generator().manual_seed(1))
    generator = torch.Generator().manual_seed(7)
    set_dropout_generator(model.train(), generator)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32))
    loss = model(x).square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads, generator.get_state()


def test_remat_with_dropout_draws_the_forward_masks(monkeypatch):
    """The recompute of a checkpointed block draws the masks its forward
    drew, and the generator ends where it ends without remat. The plain
    ``checkpoint`` (which restores only the default generators) would give
    other gradients and move the generator twice."""
    loss, grads, end = _remat_grads(remat=False)
    loss_r, grads_r, end_r = _remat_grads(remat=True)
    assert torch.equal(loss, loss_r) and torch.equal(end, end_r)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)
    monkeypatch.setattr(port_vit, "remat_block", lambda block, x: port_vit.checkpoint(
        block, x, use_reentrant=False))
    _, grads_plain, end_plain = _remat_grads(remat=True)
    assert not torch.equal(end_plain, end)
    assert any(not torch.allclose(a, b, atol=1e-4) for a, b in zip(grads, grads_plain))


def test_attention_dropout_takes_the_dense_path_and_kernels_refuse_it(monkeypatch):
    """In training with attention dropout, ``auto`` takes the dense path
    and an explicit kernel backend raises, as sav_tpu does for plain and
    talking-heads attention; in eval mode the kernels run as before."""
    q = jnp.zeros((1, 8, 2, 16))
    for backend in ("pallas", "fused"):
        with pytest.raises(ValueError, match="deterministic"):
            jax_dot_product_attention(q, q, q, backend=backend, dropout_rate=0.1,
                                      dropout_rng=jax.random.PRNGKey(0), deterministic=False)
    assert port_attention.resolve_attention_backend(8, 8, 16, dropout=True) == "xla"
    assert port_th.resolve_talking_heads_backend(2, 8, 16, dropout=True) == "xla"
    for backend in ("pallas", "fused"):
        with pytest.raises(ValueError, match="deterministic"):
            port_attention.resolve_attention_backend(8, 8, 16, requested=backend, dropout=True)
        with pytest.raises(ValueError, match="deterministic-only"):
            port_th.resolve_talking_heads_backend(2, 8, 16, requested=backend, dropout=True)

    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(0))
    for talking_heads in (False, True):
        block = AttentionBlock(32, 2, talking_heads=talking_heads, backend="fused",
                               attn_dropout_rate=0.1)
        block.reset_parameters(torch.Generator().manual_seed(1))
        set_dropout_generator(block, torch.Generator().manual_seed(2))
        with torch.no_grad():
            block.eval()(x, x)  # eval: the kernel path
            with pytest.raises(ValueError, match="deterministic"):
                block.train()(x, x)
    calls = []
    real = port_fused.fused_attention
    monkeypatch.setattr(port_fused, "fused_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    block = AttentionBlock(32, 2, attn_dropout_rate=0.1)
    block.reset_parameters(torch.Generator().manual_seed(1))
    set_dropout_generator(block, torch.Generator().manual_seed(2))
    with torch.no_grad():
        block.train()(x, x)
        assert calls == []
        block.eval()(x, x)
        assert calls == [1]


# ---------------------------------------------------------------- presets


@pytest.mark.parametrize("name", jax_preset_names())
def test_every_sav_tpu_preset_exists_with_its_fields(name):
    ref = jax_get_preset(name)
    got = get_preset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_presets_refuse_what_trainconfig_refuses():
    assert preset_names() == jax_preset_names()
    with pytest.raises(NotImplementedError) as from_preset:
        get_preset("deit_s_imagenet", profile_dir="prof")
    with pytest.raises(NotImplementedError) as from_config:
        TrainConfig(profile_dir="prof")
    assert str(from_preset.value) == str(from_config.value)
    with pytest.raises(ValueError, match="unknown preset"):
        get_preset("nope")
    mixer = get_preset("mixer_b_imagenet")
    model = create_model(mixer.model_name, num_classes=mixer.num_classes,
                         image_size=mixer.image_size)
    assert type(model).__name__ == "MLPMixer" and len(model.blocks) == 12
    botnet = get_preset("botnet_t3_imagenet", num_train_images=2048 * 6, warmup_epochs=0)
    assert (botnet.global_batch_size, botnet.learning_rate, botnet.steps_per_epoch) == (2048, 1e-3, 6)


# -------------------------------------------------------------------- CLI


def test_cli_checkpoints_resumes_and_prefers_the_checkpoint_over_init_from(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    common = ["--synth-data", "-m", "vit_ti_patch16", "--image-size", "32", "--batch-size", "8",
              "--num-classes", "10", "--device", "cpu", "--dtype", "float32", "-c", ckpt,
              "--checkpoint-every-steps", "2", "--log-every-steps", "1", "--grad-accum", "2",
              "--ema-decay", "0.9"]
    first = main(common + ["--steps", "4"])
    assert (first["start_step"], first["step"]) == (0, 4)
    saved = json.loads((tmp_path / "run" / "4" / "config.json").read_text())
    assert (saved["grad_accum_steps"], saved["ema_decay"], saved["checkpoint_every_steps"]) == (2, 0.9, 2)
    # A missing --init-from directory would raise if it were read: -c wins.
    second = main(common + ["--steps", "6", "--init-from", str(tmp_path / "missing")])
    assert (second["start_step"], second["step"]) == (4, 6) and np.isfinite(second["loss"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 6 and line["start_step"] == 4
    # An empty -c with --init-from warm-starts from the first run, at step 0.
    warm = [a if a != ckpt else str(tmp_path / "warm") for a in common]
    third = main(warm + ["--steps", "1", "--init-from", ckpt])
    assert (third["start_step"], third["step"]) == (0, 1)


def test_cli_preset_under_its_flags(tmp_path):
    """--preset supplies the recipe; the flags given override it."""
    final = main(["--synth-data", "--preset", "elastic_smoke", "--batch-size", "4", "--steps", "2",
                  "--device", "cpu", "-c", str(tmp_path / "preset")])
    assert (final["start_step"], final["step"]) == (0, 2)
    saved = json.loads((tmp_path / "preset" / "2" / "config.json").read_text())
    assert saved["global_batch_size"] == 4 and saved["model_overrides"]["num_layers"] == 2
    assert saved["log_every_steps"] == 2 and saved["seed"] == 0
