"""The port's training slice (sav_tpu_torch.train) against sav_tpu's, on the CPU.

Both sides get the same numpy inputs and, through ``params_from_flax``, the
same parameters. The fused attention runs its plain forward and plain
backward on the port's side (CPU tensors) and the Pallas kernels in
interpret mode on sav_tpu's, as tests/test_fused_attention.py runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sav_tpu.data import synthetic as jax_synthetic
from sav_tpu.models import create_model as jax_create_model
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu.train.config import TrainConfig as JaxTrainConfig
from sav_tpu.utils import metrics as jax_metrics
from sav_tpu_torch.data import synthetic
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import TrainConfig, Trainer, main
from sav_tpu_torch.train import optimizer as port_optimizer
from sav_tpu_torch.utils import metrics as port_metrics

torch.set_num_threads(2)

# embed 64, 2 layers, 4 heads of 16, patch 8 at 32x32: L = 17 (ragged).
SMALL = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8))
# Where a parameter of 0 exact gradient may stand after 4 noise-driven Adam
# steps (see _four_steps_against_sav_tpu's zero_grad_params): far below
# what one step of a real gradient moves it (base_lr · 1 at lr 0.02).
ZERO_GRAD_LIMIT = 1e-3


def _flax_params(seed=0, head_std=0.02):
    """sav_tpu's init of the small ViT as numpy, with the zero-init head
    drawn at ``head_std`` from a numpy seed (a zero head passes no gradient
    to the attention cores)."""
    model = jax_create_model("vit_ti_patch16", num_classes=10, **SMALL)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)), is_training=False
    )
    params = jax.tree.map(np.asarray, variables["params"])
    params["head"]["kernel"] = (
        np.random.default_rng(seed + 1)
        .normal(0.0, head_std, params["head"]["kernel"].shape)
        .astype(np.float32)
    )
    return params


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize(
    "lr,spe,warmup,epochs,end",
    [
        (1e-3, 10, 5, 300, 1e-5),  # the recipe's shape
        (5e-4, 4, 0, 2, 1e-5),  # no warmup: one warmup step, lr 0 at step 0
        (2e-3, 3, 4, 2, 0.0),  # warmup longer than the run
        (0.0, 5, 1, 3, 1e-5),  # lr 0: alpha 0
    ],
)
def test_schedule_matches_optax(lr, spe, warmup, epochs, end):
    kw = dict(steps_per_epoch=spe, warmup_epochs=warmup, num_epochs=epochs, end_lr=end)
    ref = jax_optimizer.warmup_cosine_schedule(lr, **kw)
    ours = port_optimizer.warmup_cosine_schedule(lr, **kw)
    total = spe * epochs
    steps = sorted({0, 1, 2, spe * warmup - 1, spe * warmup, spe * warmup + 1,
                    total // 2, total - 1, total, total + 7} - {-1})
    # rtol 1e-5: optax evaluates in f32, with its warmup as
    # (0 − peak)·(1 − t/W) + peak (a cancellation); the port in f64.
    for step in steps:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {step}")
    assert ours(0) == 0.0


# ------------------------------------------------------------ decay mask


def test_weight_decay_mask_matches_sav_tpu():
    params = _flax_params()
    flax_mask = jax_optimizer.weight_decay_mask(params)
    # Shape the bools like their leaves so the converter maps names across.
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["encoder.blocks.0.attn.to_qkv"] and got["encoder.blocks.0.attn.to_out"]
    assert not got["cls"] and not got["encoder.pos_embed.pos_embed"]
    assert not got["encoder.blocks.0.norm1.weight"] and not got["head.bias"]


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize(
    "grad_scale,ema_decay",
    [(10.0, None), (1e-3, None), (10.0, 0.9)],  # clipped, not clipped, with EMA
)
def test_three_updates_match_optax(grad_scale, ema_decay):
    params = _flax_params()
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    grads = [
        jax.tree.map(lambda p: (grad_scale * rng.standard_normal(p.shape)).astype(np.float32), params)
        for _ in range(3)
    ]
    kw = dict(steps_per_epoch=1, warmup_epochs=1, num_epochs=5, end_lr=1e-5)
    tx = jax_optimizer.make_optimizer(
        jax_optimizer.warmup_cosine_schedule(0.1, **kw),
        weight_decay=0.05, clip_grad_norm=1.0, ema_decay=ema_decay,
    )
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    names = list(params_from_flax(params))
    ours = list(params_from_flax(params).values())
    mask_by_name = port_optimizer.weight_decay_mask(zip(names, ours))
    adamw = port_optimizer.make_optimizer(
        port_optimizer.warmup_cosine_schedule(0.1, **kw),
        weight_decay=0.05, clip_grad_norm=1.0, ema_decay=ema_decay,
    )
    state = adamw.init(ours)
    for g in grads:
        converted = params_from_flax(g)
        state = adamw.step(ours, [converted[n] for n in names], [mask_by_name[n] for n in names], state)
    assert state.count == 3
    # atol 1e-5 against updates of size lr = 0.1: optax forms the bias
    # corrections 1 − bᵗ in f32 (1 − 0.999² keeps ~4 digits), the port in f64.
    want = params_from_flax(jax.tree.map(np.asarray, jp))
    for name, got in zip(names, ours):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    if ema_decay is not None:
        want_ema = params_from_flax(jax.tree.map(np.asarray, jax_optimizer.ema_params(opt_state)))
        for name, got in zip(names, state.ema):
            np.testing.assert_allclose(got.numpy(), want_ema[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------- metrics


def test_cross_entropy_and_topk_match_sav_tpu():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, (16,)).astype(np.int32)
    probs = rng.dirichlet(np.ones(10), 16).astype(np.float32)
    ref = float(jax_metrics.cross_entropy(jnp.asarray(logits), jnp.asarray(probs)))
    got = port_metrics.cross_entropy(torch.from_numpy(logits), torch.from_numpy(probs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    # bf16 logits: the loss is still taken in f32.
    logits16 = torch.from_numpy(logits).bfloat16()
    ref16 = float(jax_metrics.cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(probs)))
    np.testing.assert_allclose(float(port_metrics.cross_entropy(logits16, torch.from_numpy(probs))), ref16, rtol=1e-6)

    ref_acc = jax_metrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels))
    got_acc = port_metrics.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels))
    assert set(got_acc) == set(ref_acc) == {"top_1_acc", "top_5_acc"}
    for k in ref_acc:
        np.testing.assert_array_equal(got_acc[k].numpy(), np.asarray(ref_acc[k]))
    means = port_metrics.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(means["top_1_acc"]) == float(np.mean(np.asarray(ref_acc["top_1_acc"])))


def _small_trainer(**config):
    cfg = TrainConfig(
        model_name="vit_ti_patch16", num_classes=10, image_size=32,
        compute_dtype="float32", global_batch_size=16, transpose_images=False,
        model_overrides=dict(SMALL), **config,
    )
    return Trainer(cfg, device="cpu")


def test_label_smoothing_and_mix_labels_match_sav_tpu():
    rng = np.random.default_rng(9)
    batch = {
        "labels": rng.integers(0, 10, (16,)).astype(np.int32),
        "mix_labels": rng.integers(0, 10, (16,)).astype(np.int32),
        "ratio": rng.uniform(size=(16,)).astype(np.float32),
    }
    trainer = _small_trainer(label_smoothing=0.1)
    got = trainer._label_probs(batch, trainer._labels(batch))
    # sav_tpu's Trainer._label_probs, step by step.
    onehot = jax.nn.one_hot(batch["labels"], 10, dtype=jnp.float32)
    mix = jax.nn.one_hot(batch["mix_labels"], 10, dtype=jnp.float32)
    ratio = jnp.asarray(batch["ratio"])[:, None]
    want = optax.smooth_labels(ratio * onehot + (1.0 - ratio) * mix, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


# ------------------------------------------------------------ data, config


def test_synthetic_batches_match_sav_tpu():
    kw = dict(batch_size=4, image_size=8, num_classes=10, seed=3, num_batches=2)
    for transpose in (False, True):
        for a, b in zip(synthetic.synthetic_data_iterator(transpose=transpose, **kw),
                        jax_synthetic.synthetic_data_iterator(transpose=transpose, **kw)):
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
    a = synthetic.synth_batch(seed=5, position=3, batch_size=4, image_size=8)
    b = jax_synthetic.synth_batch(seed=5, position=3, batch_size=4, image_size=8)
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    fake = next(synthetic.fake_data_iterator(batch_size=2, image_size=8, transpose=True))
    assert fake["images"].shape == (8, 8, 3, 2) and not fake["images"].any()


def test_train_config_mirrors_sav_tpu_and_refuses_what_it_does_not_carry():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == theirs
    cfg, ref = TrainConfig(global_batch_size=256), JaxTrainConfig(global_batch_size=256)
    assert (cfg.steps_per_epoch, cfg.total_steps, cfg.learning_rate) == (
        ref.steps_per_epoch, ref.total_steps, ref.learning_rate)
    assert TrainConfig.from_json(cfg.to_json()) == cfg
    for field, value, item in (
        ("quant", "int8", "A8"), ("profile_dir", "prof", "A10"),
        ("mesh_axes", {"data": 8}, "A9"), ("diagnostics", True, "A10"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            TrainConfig(**{field: value})
    TrainConfig(fused_optimizer=False, ema_decay=0.99, augment="none")  # carried
    # Carried since gradient accumulation and checkpointing were ported.
    for field, value in (("grad_accum_steps", 2), ("checkpoint_dir", "ckpt"),
                         ("eval_every_epochs", 1), ("checkpoint_every_steps", 10)):
        assert getattr(TrainConfig(**{field: value}), field) == value
    # Carried since the run telemetry and the supervisor were ported.
    for field, value in (("log_dir", "logs"), ("watchdog_secs", 30.0), ("record", True),
                         ("debug_nans", True), ("trace_spans", True), ("fleet", False),
                         ("watchdog_soft_secs", 10.0), ("record_depth", 8),
                         ("record_batches", 2), ("record_snapshot_every", 2),
                         ("spike_sigma", 0.0)):
        assert getattr(TrainConfig(**{field: value}), field) == value
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        TrainConfig(grad_accum_steps=0)


def test_trainer_refuses_a_missing_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(model_name="vit_ti_patch16", image_size=32, model_overrides=dict(SMALL)))
    trainer = _small_trainer()
    assert trainer.device.type == "cpu"
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_init_state_draws_from_the_seed_and_keeps_a_passed_model():
    def snapshot(state):  # the state's model is updated in place
        return {k: v.clone() for k, v in state.model.state_dict().items()}

    trainer = _small_trainer(seed=3)
    a = snapshot(trainer.init_state())
    b = snapshot(trainer.init_state(seed=3))
    c = snapshot(trainer.init_state(seed=4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.blocks.0.attn.to_qkv"], c["encoder.blocks.0.attn.to_qkv"])
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, seed=5, **SMALL)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    passed = Trainer(_small_trainer().config, model=model, device="cpu").init_state()
    assert passed.step == 0 and passed.opt_state.count == 0 and passed.batch_stats == {}
    assert all(torch.equal(want[k], v) for k, v in passed.model.state_dict().items())


def test_hwcn_batches_are_transposed():
    trainer = _small_trainer()
    trainer.config.transpose_images = True
    images = np.random.default_rng(10).standard_normal((32, 32, 3, 2)).astype(np.float32)
    got = trainer._prep_images(images)
    np.testing.assert_array_equal(got.numpy(), np.transpose(images, (3, 0, 1, 2)))
    with pytest.raises(ValueError, match="uint8"):
        trainer._prep_images(np.zeros((2, 32, 32, 3), np.uint8))


# ------------------------------------------------------------------ slice


def _four_steps_against_sav_tpu(model_name, overrides, params, backend="fused",
                                model_overrides=None, image_size=32, batch_stats=None,
                                base_lr=0.05, grad_accum_steps=1, batch_size=16,
                                zero_grad_params=(), aux_tol=0.0):
    """4 f32 steps at ``backend`` from one parameter tree (and, for a
    BatchNorm model, its ``batch_stats``) and one batch stream, on sav_tpu's
    Trainer (8-device CPU mesh, Pallas in interpret mode) and the port's,
    both models built with ``model_overrides``, each step over
    ``grad_accum_steps`` micro-batches of a global ``batch_size``. Per-step loss, grad norm and
    lr, then every parameter, every running statistic and the eval sums,
    agree within f32 tolerances (different
    summation orders over 4 Adam steps; Adam divides by √v, which keeps
    relative errors relative).

    ``aux_tol`` is the relative tolerance of the ``aux_loss`` metric: 0
    for a model that sows no loss (0 on both sides), f32's for one that
    does. Returns the port's fit history.

    ``zero_grad_params`` names parameters whose gradient is 0 in exact
    arithmetic (a bias right before a train-mode BatchNorm, which subtracts
    it again with the batch mean): their f32 gradients are rounding noise,
    which Adam scales up to steps of the learning rate's order, so their
    values cannot agree and are not compared; each is held at 0 on both
    sides within the noise-driven steps it can take
    (``ZERO_GRAD_LIMIT``)."""
    from sav_tpu.train.trainer import Trainer as JaxTrainer

    common = dict(
        model_name=model_name, num_classes=10, image_size=image_size,
        compute_dtype="float32", attention_backend=backend,
        model_overrides=model_overrides, global_batch_size=batch_size,
        num_train_images=4 * batch_size, num_epochs=2,
        warmup_epochs=0, transpose_images=False, base_lr=base_lr, seed=0,
        grad_accum_steps=grad_accum_steps,
    )
    batches = list(synthetic.synthetic_data_iterator(
        batch_size=batch_size, image_size=image_size, num_classes=10, seed=11, num_batches=4
    ))

    jax_model = jax_create_model(
        model_name, num_classes=10, dtype=jnp.float32, backend=backend, **overrides,
        **(model_overrides or {}),
    )
    jax_trainer = JaxTrainer(JaxTrainConfig(**common), model=jax_model)
    jstate = jax_trainer.init_state()
    def place(new, old):
        return jax.tree.map(lambda n, o: jax.device_put(n, o.sharding), new, old)

    jstate = jstate.replace(params=place(params, jstate.params))
    variables = params
    if batch_stats is not None:
        jstate = jstate.replace(batch_stats=place(batch_stats, jstate.batch_stats))
        variables = {"params": params, "batch_stats": batch_stats}
    jax_metrics_per_step = []
    for batch in batches:
        jstate, m = jax_trainer.train_step(jstate, batch, jax.random.PRNGKey(0))
        jax_metrics_per_step.append({k: float(v) for k, v in jax.device_get(m).items()})
    jax_eval = {k: float(v) for k, v in jax.device_get(jax_trainer.eval_step(jstate, batches[0])).items()}

    model = create_model(model_name, num_classes=10, image_size=image_size, backend=backend,
                         **overrides, **(model_overrides or {}))
    model.load_state_dict(params_from_flax(variables), strict=True)
    trainer = Trainer(TrainConfig(**common), model=model, device="cpu")
    state = trainer.init_state()
    state, history = trainer.fit(iter(batches), num_steps=4, state=state)
    assert state.step == 4 and [r["step"] for r in history] == [1, 2, 3, 4]

    assert jax_metrics_per_step[0]["learning_rate"] == 0.0 < jax_metrics_per_step[1]["learning_rate"]
    for step, (ours, ref) in enumerate(zip(history, jax_metrics_per_step)):
        for key, atol, rtol in (("loss", 1e-5, 1e-5), ("grad_norm", 1e-6, 1e-4),
                                ("learning_rate", 1e-12, 1e-5), ("aux_loss", 0, aux_tol)):
            np.testing.assert_allclose(ours[key], ref[key], atol=atol, rtol=rtol,
                                       err_msg=f"{key} at step {step}")
    assert history[-1]["loss"] < history[0]["loss"]

    final = {"params": jstate.params}
    if batch_stats is not None:
        final["batch_stats"] = jstate.batch_stats
        assert set(state.batch_stats) == {k for k in state.model.state_dict() if "running" in k}
    want = params_from_flax(jax.tree.map(np.asarray, jax.device_get(final)))
    for name, value in state.model.state_dict().items():
        if name in zero_grad_params:
            for side in (value.numpy(), want[name].numpy()):
                assert np.abs(side).max() < ZERO_GRAD_LIMIT, name
            continue
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4, err_msg=name)
    ours_eval = {k: float(v) for k, v in trainer.eval_step(state, batches[0]).items()}
    for key in ("loss_sum", "top_1_sum", "top_5_sum", "count"):
        np.testing.assert_allclose(ours_eval[key], jax_eval[key], atol=1e-4, rtol=1e-5, err_msg=key)
    return history


def test_four_train_steps_match_sav_tpu():
    """The ViT slice as a whole: 4 f32 steps of a 2-layer, width-64, 4-head
    ViT (see _four_steps_against_sav_tpu)."""
    _four_steps_against_sav_tpu("vit_ti_patch16", SMALL, _flax_params())


def test_four_remat_flash_train_steps_match_sav_tpu():
    """The ViT-B/16@384 fine-tune path at small size: the same 2-layer ViT at
    backend 'pallas' (the flash kernels' plain versions here, the Pallas
    flash kernels in interpret mode there) with remat on both sides."""
    _four_steps_against_sav_tpu("vit_ti_patch16", SMALL, _flax_params(), backend="pallas",
                                model_overrides={"remat": True})


def test_four_cait_train_steps_match_sav_tpu():
    """The CaiT slice as a whole: 4 f32 steps of the small CaiT (2
    talking-heads layers, 1 class-attention layer) at stochastic depth 0
    (jax.random draws cannot be matched), LayerScale and head drawn so that
    the trunk's gradients count."""
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    _four_steps_against_sav_tpu("cait_xxs_24", CAIT_SMALL, small_flax_params())


def test_four_botnet_train_steps_match_sav_tpu():
    """The BoTNet slice as a whole: 4 f32 steps of the small BoTNet (every
    stage one block, 64², one BoTBlock over 4×4) at backend 'pallas', from
    drawn bn3 scales, head and running statistics; the running statistics
    are updated in each train step and compared after the last. Base lr
    0.02: BatchNorm at batch 16 with bn3 scales near 1 makes the loss jump
    at 0.05."""
    from test_torch_botnet import IMAGE, small_flax_variables
    from test_torch_botnet import SMALL as BOTNET_SMALL

    variables = small_flax_variables(seed=3)
    _four_steps_against_sav_tpu("botnet_t3", BOTNET_SMALL, variables["params"], backend="pallas",
                                image_size=IMAGE, batch_stats=variables["batch_stats"],
                                base_lr=0.02)


def test_weight_decay_mask_on_the_cait_tree_matches_sav_tpu():
    """By flax path and by port name the same leaves decay: the [H, H]
    mixing kernels (rank 2) and the class-attention projections do, the
    LayerScale scales (rank 1) and the CLS token do not."""
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    params = small_flax_params()
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("cait_xxs_24", num_classes=10, image_size=32, **CAIT_SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["blocks.0.attn.pre_softmax.kernel"] and got["blocks.0.attn.post_softmax.kernel"]
    assert all(got[f"ca_blocks.0.attn.to_{p}"] for p in ("q", "k", "v", "out"))
    assert not got["blocks.0.ls1.scale"] and not got["ca_blocks.0.ls2.scale"] and not got["cls"]


def test_eval_step_runs_on_the_parameter_ema():
    """With ema_decay set, eval uses the averaged weights (sav_tpu's
    ``_eval_step_impl``): the same sums as the model loaded with the EMA."""
    trainer = _small_trainer(ema_decay=0.5, base_lr=0.5, warmup_epochs=0, num_train_images=64)
    batches = list(synthetic.synthetic_data_iterator(batch_size=16, image_size=32,
                                                     num_classes=10, num_batches=3))
    state, _ = trainer.fit(iter(batches), num_steps=3)
    assert not torch.equal(state.opt_state.ema[0], next(state.model.parameters()))
    got = {k: float(v) for k, v in trainer.eval_step(state, batches[0]).items()}
    averaged = create_model("vit_ti_patch16", num_classes=10, image_size=32, **SMALL)
    averaged.load_state_dict(dict(zip(trainer._param_names, state.opt_state.ema)))
    reference = Trainer(trainer.config, model=averaged, device="cpu")
    want = reference.eval_step(reference.init_state(), batches[0])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], float(value), rtol=1e-6, err_msg=key)


def test_fit_brings_metrics_to_the_host_once_per_window(monkeypatch):
    from sav_tpu_torch.train import trainer as trainer_module

    calls = []
    real = trainer_module._to_host
    monkeypatch.setattr(trainer_module, "_to_host", lambda w: calls.append(len(w)) or real(w))
    trainer = _small_trainer(log_every_steps=2)
    batches = synthetic.synthetic_data_iterator(batch_size=16, image_size=32, num_classes=10)
    logged = []
    _, history = trainer.fit(batches, num_steps=5, log_fn=logged.append)
    assert calls == [2, 2, 1] and len(history) == 5
    assert [r["step"] for r in logged] == [2, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["images_per_sec"] > 0 for r in logged)


def test_train_cli_runs_on_the_cpu(capsys):
    final = main([
        "--synth-data", "-m", "vit_ti_patch16", "--image-size", "32", "--batch-size", "8",
        "--num-classes", "10", "--steps", "2", "--device", "cpu", "--dtype", "float32",
    ])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"step": 2' in line and final["step"] == 2 and np.isfinite(final["loss"])


def test_fit_runs_to_num_steps_in_all_and_stops_where_the_feed_ends():
    """num_steps is the total: from a state at step 2, fit(num_steps=4) runs
    steps 3 and 4; a feed that ends first stops the loop and closes the log
    window there (sav_tpu breaks on StopIteration too)."""
    trainer = _small_trainer(log_every_steps=10)
    batches = list(synthetic.synthetic_data_iterator(batch_size=16, image_size=32,
                                                     num_classes=10, num_batches=5))
    state, _ = trainer.fit(iter(batches[:2]), num_steps=2)
    state, history = trainer.fit(iter(batches[2:]), num_steps=4, state=state)
    assert state.step == 4 and [r["step"] for r in history] == [3, 4]
    state, history = trainer.fit(iter(batches[4:]), num_steps=9, state=state)
    assert state.step == 5 and [r["step"] for r in history] == [5]
    assert history[-1]["images_per_sec"] > 0
