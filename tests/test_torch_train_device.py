"""The trainer's device path (device_preprocess, the device-count AdamW, the
async feed, train_many_steps, the captured step's plumbing, remat's masks)
against sav_tpu's and against itself, on the CPU.

Tolerances: 4 f32 steps against sav_tpu's Trainer keep test_torch_train's
(loss 1e-5, grad norm 1e-4 relative, learning rate 1e-5 relative,
parameters 2e-5 absolute and 1e-4 relative: summation orders differ over 4
Adam steps); the optimizer against optax 1e-5 (optax forms its schedule and
bias corrections in f32, as the port now does, but its power and cosine are
XLA's); everything the port compares with itself is bit for bit.
"""

import dataclasses
import gc
import logging
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu.train.config import TrainConfig as JaxTrainConfig
from sav_tpu_torch.data import synthetic
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models import vit as port_vit
from sav_tpu_torch.models.layers import set_dropout_generator, set_stochastic_depth_generator
from sav_tpu_torch.train import TrainConfig, Trainer
from sav_tpu_torch.train import optimizer as port_optimizer
from sav_tpu_torch.train import trainer as trainer_module

torch.set_num_threads(2)

SMALL = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8))
TINY = dict(embed_dim=32, num_layers=1, num_heads=2, patch_shape=(8, 8))


def _uint8_batches(n, batch_size=16, image_size=32, hwcn=True, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8)
        labels = rng.integers(0, 10, (batch_size,)).astype(np.int32)
        # Brightness carries the class, so the loss can fall.
        images = np.clip(images.astype(np.int32) // 2 + labels[:, None, None, None] * 12,
                         0, 255).astype(np.uint8)
        if hwcn:
            images = np.ascontiguousarray(np.transpose(images, (1, 2, 3, 0)))
        out.append({"images": images, "labels": labels})
    return out


def _tiny_trainer(**config):
    return Trainer(TrainConfig(**{
        **dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
               compute_dtype="float32", global_batch_size=8, transpose_images=False,
               model_overrides=dict(TINY), seed=0, num_train_images=64, num_epochs=4,
               warmup_epochs=1, base_lr=0.05), **config}), device="cpu")


def _tiny_batches(n, seed=3):
    return list(synthetic.synthetic_data_iterator(batch_size=8, image_size=32, num_classes=10,
                                                  seed=seed, num_batches=n))


def _equal_trees(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------- device_preprocess


def test_device_preprocessed_steps_match_sav_tpu():
    """4 f32 steps of the 2-layer ViT with ``device_preprocess`` on uint8
    HWCN batches, against sav_tpu's Trainer with the same flag and a
    mix-free augment string: both normalise on the device inside the step."""
    from sav_tpu.train.trainer import Trainer as JaxTrainer
    from test_torch_train import _flax_params

    params = _flax_params()
    common = dict(
        model_name="vit_ti_patch16", num_classes=10, image_size=32, compute_dtype="float32",
        attention_backend="fused", global_batch_size=16, num_train_images=64, num_epochs=2,
        warmup_epochs=0, transpose_images=True, base_lr=0.05, seed=0,
        device_preprocess=True, augment="randaugment_405",
    )
    batches = _uint8_batches(4)
    jax_model = __import__("sav_tpu.models", fromlist=["create_model"]).create_model(
        "vit_ti_patch16", num_classes=10, dtype=jnp.float32, backend="fused", **SMALL)
    jax_trainer = JaxTrainer(JaxTrainConfig(**common), model=jax_model)
    jstate = jax_trainer.init_state()
    jstate = jstate.replace(params=jax.tree.map(
        lambda n, o: jax.device_put(n, o.sharding), params, jstate.params))
    ref = []
    for batch in batches:
        jstate, m = jax_trainer.train_step(jstate, batch, jax.random.PRNGKey(0))
        ref.append({k: float(v) for k, v in jax.device_get(m).items()})

    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, backend="fused", **SMALL)
    model.load_state_dict(params_from_flax(params), strict=True)
    trainer = Trainer(TrainConfig(**common), model=model, device="cpu")
    state, history = trainer.fit(iter(batches), num_steps=4, state=trainer.init_state())
    assert [r["step"] for r in history] == [1, 2, 3, 4]
    for step, (ours, want) in enumerate(zip(history, ref)):
        for key, atol, rtol in (("loss", 1e-5, 1e-5), ("grad_norm", 1e-6, 1e-4),
                                ("learning_rate", 1e-12, 1e-5)):
            np.testing.assert_allclose(ours[key], want[key], atol=atol, rtol=rtol,
                                       err_msg=f"{key} at step {step}")
    assert history[-1]["loss"] < history[0]["loss"]
    want = params_from_flax(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    for name, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_device_preprocess_refuses_the_other_dtype_with_sav_tpus_messages():
    plain = _tiny_trainer()
    with pytest.raises(ValueError, match="uint8 images with device_preprocess=False"):
        plain.train_step(plain.init_state(), _uint8_batches(1, 8, hwcn=False)[0])
    pre = _tiny_trainer(device_preprocess=True)
    with pytest.raises(ValueError, match="device_preprocess=True expects uint8 batches"):
        pre.train_step(pre.init_state(), _tiny_batches(1)[0])


def test_device_mixes_draw_from_the_mix_generator():
    """With ``cutmix_mixup`` the step mixes on the device from the trainer's
    ``"mix"`` generator (seeded from ``stream_seed(seed, "mix")``): two
    trainers of one seed take the same steps; the stochastic-depth and
    dropout generators are not moved by the mixes."""
    batches = _uint8_batches(2, batch_size=8, hwcn=False)

    def run(seed):
        trainer = _tiny_trainer(device_preprocess=True, augment="cutmix_mixup", seed=seed)
        state = trainer.init_state()
        before = {k: g.get_state() for k, g in trainer.generators.items()}
        losses = []
        for batch in batches:
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        after = {k: g.get_state() for k, g in trainer.generators.items()}
        return losses, before, after

    a, before, after = run(0)
    b, _, _ = run(0)
    c, _, _ = run(1)
    assert a == b and a != c
    assert not torch.equal(before["mix"], after["mix"])
    assert torch.equal(before["dropout"], after["dropout"])
    assert torch.equal(before["stochastic_depth"], after["stochastic_depth"])
    gen = torch.Generator().manual_seed(trainer_module.stream_seed(0, "mix"))
    assert torch.equal(before["mix"], gen.get_state())


def test_a_checkpoint_without_the_mix_generator_restores(tmp_path, caplog):
    """Checkpoints written before the ``"mix"`` generator existed restore:
    it keeps its fresh state from the seed, with a warning."""
    trainer = _tiny_trainer(checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    state, _ = trainer.train_step(state, _tiny_batches(1)[0])
    trainer.checkpointer.save(state.step, dataclasses.replace(
        state, generators={k: g for k, g in state.generators.items() if k != "mix"}))
    trainer.checkpointer.close()
    path = tmp_path / "1" / "generators.pt"
    assert set(torch.load(path, weights_only=True)["generators"]) == {"dropout",
                                                                      "stochastic_depth"}
    fresh = _tiny_trainer(checkpoint_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        restored = fresh.restore_or_init()
    assert restored.step == 1 and "'mix' generator" in caplog.text
    gen = torch.Generator().manual_seed(trainer_module.stream_seed(0, "mix"))
    assert torch.equal(fresh.generators["mix"].get_state(), gen.get_state())
    assert int(restored.opt_state.count) == 1
    fresh.checkpointer.close()


# --------------------------------------------------------------- optimizer


def test_device_count_adamw_matches_optax_past_warmup():
    """Six updates with a 3-step warm-up: the count is a 0-d int32 tensor on
    the parameters' device, advanced in place, and each update's learning
    rate (the schedule at the count before it) and parameters follow
    optax's."""
    rng = np.random.default_rng(4)
    shapes = [(8, 4), (4,), (3, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(3.0 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(6)]
    kw = dict(steps_per_epoch=1, warmup_epochs=3, num_epochs=8, end_lr=1e-5)
    tx = jax_optimizer.make_optimizer(jax_optimizer.warmup_cosine_schedule(0.1, **kw),
                                      weight_decay=0.05, clip_grad_norm=1.0)
    schedule = jax_optimizer.warmup_cosine_schedule(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    ours = [torch.from_numpy(p.copy()) for p in params]
    adamw = port_optimizer.make_optimizer(port_optimizer.warmup_cosine_schedule(0.1, **kw),
                                          weight_decay=0.05, clip_grad_norm=1.0)
    state = adamw.init(ours)
    assert state.count.dtype == torch.int32 and state.count.shape == ()
    count = state.count
    mask = [p.ndim >= 2 for p in ours]
    for i, g in enumerate(grads):
        lr = adamw.schedule(state.count)
        np.testing.assert_allclose(float(lr), float(schedule(i)), rtol=1e-5, atol=1e-12)
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        state = adamw.step(ours, [torch.from_numpy(x) for x in g], mask, state)
        assert state.count is count and int(count) == i + 1
    assert float(adamw.schedule(state.count)) > 0.0
    for got, want in zip(ours, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_schedule_takes_a_device_count_and_an_int():
    schedule = port_optimizer.warmup_cosine_schedule(1e-3, steps_per_epoch=10, warmup_epochs=2,
                                                     num_epochs=5)
    for step in (0, 7, 20, 33, 50, 60):
        a = schedule(torch.tensor(step, dtype=torch.int32))
        assert a.dtype == torch.float32 and a.shape == ()
        assert torch.equal(a, schedule(step))


# -------------------------------------------------------------------- feed


def _fit(async_feed, batches, **config):
    trainer = _tiny_trainer(async_feed=async_feed, log_every_steps=2, **config)
    state, history = trainer.fit(iter(batches), num_steps=len(batches),
                                 state=trainer.init_state())
    return trainer, state, history


@pytest.mark.parametrize("feed_depth", [1, 2])
def test_fit_with_and_without_the_async_feed_agree(feed_depth):
    batches = _tiny_batches(5)
    on, state_on, hist_on = _fit(True, batches, feed_depth=feed_depth)
    off, state_off, hist_off = _fit(False, batches, feed_depth=feed_depth)
    timing = ("step_s", "images_per_sec")
    strip = [{k: v for k, v in r.items() if not k.startswith("feeder_") and k not in timing}
             for r in hist_on]
    assert strip == [{k: v for k, v in r.items() if k not in timing} for r in hist_off]
    assert _equal_trees(state_on.model.state_dict(), state_off.model.state_dict())
    for a, b in zip(state_on.opt_state.mu, state_off.opt_state.mu):
        assert torch.equal(a, b)
    last = hist_on[-1]
    assert last["feeder_batches"] >= 5 and last["feeder_depth"] == feed_depth
    assert {"feeder_h2d_s", "feeder_depth_avg", "feeder_wait_s"} <= set(last)
    assert on.last_feeder_stats["batches"] >= 5 and off.last_feeder_stats is None
    assert not any(k.startswith("feeder_") for r in hist_on[:-1] for k in r)


def _feeder_threads():
    return [t for t in threading.enumerate() if t.name == "train-feeder" and t.is_alive()]


def test_the_feeder_runs_ahead_at_most_depth_plus_one_and_closes_on_early_stop():
    """``fit`` stops at ``num_steps`` with the feed still going: the feeder
    has pulled at most ``feed_depth + 1`` batches beyond the steps, and its
    thread is gone."""
    pulled = []

    def endless():
        for i, batch in enumerate(iter(lambda: _tiny_batches(1, seed=9)[0], None)):
            pulled.append(i)
            yield batch

    trainer = _tiny_trainer(feed_depth=2, log_every_steps=3)
    trainer.fit(endless(), num_steps=3, state=trainer.init_state())
    assert 3 <= len(pulled) <= 3 + 2 + 1
    assert not _feeder_threads()


@pytest.mark.parametrize("where", ["source", "step"])
def test_an_exception_passes_through_fit_and_the_feeder_closes(where):
    batches = _tiny_batches(3)

    def source():
        yield batches[0]
        # A label past num_classes fails the step's one-hot.
        yield batches[1] if where == "source" else {**batches[1], "labels": batches[1]["labels"] + 99}
        if where == "source":
            raise KeyError("the source failed")
        yield batches[2]

    trainer = _tiny_trainer(feed_depth=1)
    with pytest.raises(KeyError if where == "source" else RuntimeError):
        trainer.fit(source(), num_steps=3, state=trainer.init_state())
    assert not _feeder_threads()


def test_evaluate_with_and_without_the_async_feed_agree():
    batches = _tiny_batches(3)
    batches[-1] = {k: v[:5] for k, v in batches[-1].items()}  # padded
    results = []
    for async_feed in (True, False):
        trainer = _tiny_trainer(async_feed=async_feed)
        results.append(trainer.evaluate(trainer.init_state(), iter(batches)))
    assert results[0] == results[1] and results[0]["eval_count"] == 21


# --------------------------------------------------------------- step API


def test_train_many_steps_equals_k_train_steps():
    batches = _tiny_batches(3)
    a = _tiny_trainer()
    state_a = a.init_state()
    per_step = []
    for batch in batches:
        state_a, m = a.train_step(state_a, batch)
        per_step.append(m)
    b = _tiny_trainer()
    stacked = {k: np.stack([batch[k] for batch in batches]) for k in batches[0]}
    state_b, metrics = b.train_many_steps(b.init_state(), stacked)
    assert state_b.step == state_a.step == 3
    for key, values in metrics.items():
        assert values.shape == (3,)
        assert torch.equal(values, torch.stack([m[key] for m in per_step])), key
    assert _equal_trees(state_a.model.state_dict(), state_b.model.state_dict())
    compiled = b.compile_train_step(state_b, b.shard_batch(batches[0]))
    assert compiled.capture_s == 0.0 and compiled.captured_launches == {}
    state_b, _ = compiled(state_b, b.shard_batch(batches[0]))
    assert state_b.step == 4


class _EagerGraphs:
    """Stands in for StepGraphs on the CPU: records each construction and
    runs the step it was given, so the trainer's keying can be checked."""

    made = []

    def __init__(self, step, device, *, tensors=(), generators=(), recompute=None):
        self.step, self.tensors, self.generators = step, list(tensors), list(generators)
        _EagerGraphs.made.append(self)

    def __call__(self, batch):
        return self.step(batch)


def test_step_graphs_are_keyed_on_the_states_tensors(monkeypatch):
    """The captured steps hold the addresses of the state's tensors: the
    trainer keeps its graphs while a state brings the same tensors, and
    captures again (counted in ``recaptures``) when ``init_state``,
    ``restore_or_init`` or ``warm_start_from`` hand it new ones. A replayed
    step gives what the eager step gives."""
    monkeypatch.setattr(trainer_module, "StepGraphs", _EagerGraphs)
    _EagerGraphs.made = []
    batches = _tiny_batches(3)
    trainer = _tiny_trainer()
    trainer._feed_stream = object()  # take the card's path, without a card
    state = trainer.init_state()
    eager = _tiny_trainer()
    eager_state = eager.init_state()
    for batch in batches[:2]:
        state, m = trainer.train_step_placed(state, trainer_module.PlacedBatch(
            {k: torch.as_tensor(v) for k, v in batch.items()}))
        eager_state, want = eager.train_step(eager_state, batch)
        assert all(torch.equal(m[k], want[k].float()) for k in want)
    assert len(_EagerGraphs.made) == 1 and trainer.recaptures == 0
    graphs = _EagerGraphs.made[0]
    assert set(graphs.generators) == set(trainer.generators.values())
    assert any(t is state.opt_state.count for t in graphs.tensors)
    state = trainer.init_state()  # new tensors
    placed = {k: torch.as_tensor(v) for k, v in batches[2].items()}
    state, _ = trainer.train_step_placed(state, placed)
    assert len(_EagerGraphs.made) == 2 and trainer.recaptures == 1
    sums = trainer._step_graphs(state, "eval")(placed)
    assert sums.shape == (4,) and len(_EagerGraphs.made) == 3 and trainer.recaptures == 1
    # The graphs hold the trainer weakly: dropping it frees it (and its
    # device memory) without waiting for a collection.
    gc.disable()
    try:
        alive = weakref.ref(trainer)
        del trainer, graphs
        assert alive() is None
    finally:
        gc.enable()


def test_a_recapture_drops_the_graphs_of_both_kinds(monkeypatch):
    """A state with other tensors drops every graph held, of both kinds (each
    keeps its state's tensors alive): one recapture is counted, and the
    other kind is captured anew on its next call, not counted again."""
    monkeypatch.setattr(trainer_module, "StepGraphs", _EagerGraphs)
    _EagerGraphs.made = []
    placed = {k: torch.as_tensor(v) for k, v in _tiny_batches(1)[0].items()}
    trainer = _tiny_trainer()
    trainer._feed_stream = object()  # take the card's path, without a card
    state = trainer.init_state()
    state, _ = trainer.train_step_placed(state, placed)
    trainer._step_graphs(state, "eval")(placed)
    assert trainer.train_graphs is not None and trainer.eval_graphs is not None
    state = trainer.init_state()  # new tensors
    trainer._step_graphs(state, "eval")(placed)
    assert trainer.recaptures == 1 and trainer.train_graphs is None
    state, _ = trainer.train_step_placed(state, placed)
    assert trainer.recaptures == 1 and len(_EagerGraphs.made) == 4


# -------------------------------------------------------------------- remat


def _remat_step(remat):
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, remat=remat,
                         dropout_rate=0.2, **SMALL)
    with torch.no_grad():
        torch.nn.init.normal_(model.head.weight, std=0.5, generator=torch.Generator().manual_seed(1))
    dropout = torch.Generator().manual_seed(7)
    set_dropout_generator(model.train(), dropout)
    set_stochastic_depth_generator(model, torch.Generator().manual_seed(8))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32))
    default = torch.get_rng_state()
    loss = model(x).square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert torch.equal(default, torch.get_rng_state()), "a layer drew from the default generator"
    return loss.detach(), grads, dropout.get_state()


def test_remat_without_preserved_rng_state_draws_the_forward_masks(monkeypatch):
    """Remat's checkpoint keeps no default-generator state
    (``preserve_rng_state=False``, as a capture needs): nothing in the model
    draws from the default generator, and the recompute draws the forward's
    masks again from twins of its generators, so loss, gradients and the
    dropout generator's end state equal the run without remat, bit for
    bit."""
    calls = []
    real = port_vit.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(kwargs)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(port_vit, "checkpoint", spy)
    loss, grads, end = _remat_step(remat=False)
    loss_r, grads_r, end_r = _remat_step(remat=True)
    assert calls and all(k == {"use_reentrant": False, "preserve_rng_state": False} for k in calls)
    assert torch.equal(loss, loss_r) and torch.equal(end, end_r)
    for a, b in zip(grads, grads_r):
        assert torch.equal(a, b)


def test_trainer_remat_reuses_one_twin_per_recomputed_forward():
    """Through the trainer (its RecomputeGenerators), with two micro-batches:
    2 steps with remat equal 2 steps without, bit for bit (metrics,
    parameters, generator states), and the twins are made once, one per
    forward of a recomputed block in a step (2 blocks × 2 micro-batches,
    one generator each), then reused."""
    runs = {}
    for remat in (False, True):
        trainer = _tiny_trainer(grad_accum_steps=2, model_overrides={
            **TINY, "remat": remat, "dropout_rate": 0.2})
        state = trainer.init_state()
        metrics, twins = [], []
        for batch in _tiny_batches(2):
            state, m = trainer.train_step(state, batch)
            metrics.append(torch.stack([m[k].float() for k in ("loss", "grad_norm")]))
            twins.append(trainer.recompute_generators.generators())
        runs[remat] = (torch.stack(metrics), state.model.state_dict(),
                       {k: g.get_state() for k, g in trainer.generators.items()})
        assert len(twins[0]) == (2 * TINY["num_layers"] if remat else 0)
        assert len(twins[1]) == len(twins[0]) and all(a is b for a, b in zip(*twins))
    assert torch.equal(runs[True][0], runs[False][0])
    assert _equal_trees(runs[True][1], runs[False][1])
    assert _equal_trees(runs[True][2], runs[False][2])
