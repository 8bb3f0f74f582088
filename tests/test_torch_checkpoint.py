"""The port's checkpointing (sav_tpu_torch.train.checkpoint), resume, warm
start and the reverse conversion, on the CPU, against sav_tpu's where it has
a counterpart.

The port's side runs small f32 models (the dense attention path where the
reference's side runs too, so no Pallas kernel needs interpret mode); the
reference's Trainer runs on the 8-device CPU mesh of tests/conftest.py and
writes orbax checkpoints into the test's own temporary directory.
"""

import dataclasses
import json
import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from sav_tpu.train.config import TrainConfig as JaxTrainConfig
from sav_tpu.train.trainer import Trainer as JaxTrainer
from sav_tpu_torch.data.synthetic import synth_resumable_iterator, synthetic_data_iterator
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.layers import BatchNorm
from sav_tpu_torch.train import Checkpointer, TrainConfig, Trainer
from sav_tpu_torch.train.checkpoint import OPT_STATE_FILE, PARAMS_FILE

torch.set_num_threads(2)

# embed 64, 2 layers, 4 heads of 16, patch 8 at 32x32 (as tests/test_torch_train.py).
VIT = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8))
TINY = dict(embed_dim=16, num_layers=1, num_heads=2, patch_shape=(8, 8))
# embed 32, 2 talking-heads layers, 2 heads, 1 class-attention layer.
CAIT = dict(embed_dim=32, num_layers=2, num_heads=2, num_layers_token_only=1, patch_shape=(8, 8))
BOTNET = dict(stage_sizes=(1, 1, 1, 1))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def _assert_trees_equal(got, want, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif torch.is_tensor(want):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def _tiny_state(**config):
    trainer = Trainer(TrainConfig(
        model_name="vit_ti_patch16", num_classes=10, image_size=32, compute_dtype="float32",
        global_batch_size=4, transpose_images=False, model_overrides=dict(TINY), seed=0,
        **config), device="cpu")
    return trainer, trainer.init_state()


# --------------------------------------------------------------- surface


def test_keep_latest_and_all_steps(tmp_path):
    _, state = _tiny_state()
    ckpt = Checkpointer(str(tmp_path), keep=2)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for step in (1, 2, 3, 4):
        ckpt.save(step, dataclasses.replace(state, step=step))
    assert ckpt.wait()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert [w["step"] for w in ckpt.written] == [1, 2, 3, 4]
    ckpt.close()
    reopened = Checkpointer(str(tmp_path), read_only=True)
    assert reopened.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]  # no temporary directory left
    with pytest.raises(RuntimeError, match="read-only"):
        reopened.save(5, state)


def test_read_only_on_a_missing_directory_raises_and_creates_nothing(tmp_path):
    missing = tmp_path / "missing"
    with pytest.raises(FileNotFoundError, match="does not exist"):
        Checkpointer(str(missing), read_only=True)
    assert not missing.exists()


def test_a_truncated_newest_step_falls_back_to_the_older_one(tmp_path, caplog):
    trainer, state = _tiny_state()
    ckpt = Checkpointer(str(tmp_path))
    state = dataclasses.replace(state, step=1)
    ckpt.save(1, state)
    want = _clone(state.state_dict())
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt.save(2, dataclasses.replace(state, step=2))
    ckpt.close()
    path = tmp_path / "2" / PARAMS_FILE
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    with caplog.at_level(logging.WARNING):
        restored = ckpt.restore_latest(trainer.init_state())
    assert restored.step == 1
    assert any("resumed from the older step 1" in r.getMessage() for r in caplog.records)
    _assert_trees_equal(_clone(restored.state_dict()), want)
    (tmp_path / "1" / PARAMS_FILE).write_bytes(b"")
    with pytest.raises(Exception):
        ckpt.restore_latest(trainer.init_state())


def test_restore_params_only_never_opens_the_optimizer_state(tmp_path, monkeypatch):
    _, state = _tiny_state(ema_decay=0.9)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(7, dataclasses.replace(state, step=7))
    ckpt.close()
    opened = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda f, *a, **k: opened.append(str(f)) or real_load(f, *a, **k))
    template = {"params": state.params, "batch_stats": state.batch_stats}
    got = ckpt.restore_params_only(template)
    assert got["step"] == 7 and set(got["params"]) == set(state.params)
    assert all(torch.equal(got["params"][k], v) for k, v in state.params.items())
    assert opened and all(os.path.basename(p) == PARAMS_FILE for p in opened)
    assert not any(OPT_STATE_FILE in p for p in opened)
    bad = {"params": {"cls": torch.zeros(1, 1, 3)}}
    with pytest.raises(ValueError, match="saved shape"):
        ckpt.restore_params_only(bad)


def _hold_writes(monkeypatch):
    """torch.save held until the returned event is set."""
    release = threading.Event()
    real_save = torch.save

    def held(obj, f, *args, **kwargs):
        assert release.wait(60)
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    return release


def test_wait_returns_false_while_a_write_is_held(tmp_path, monkeypatch):
    _, state = _tiny_state()
    release = _hold_writes(monkeypatch)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, state)
    assert ckpt.wait(timeout_s=0.2) is False
    assert ckpt.all_steps() == []  # not committed: missing, not torn
    release.set()
    assert ckpt.wait(timeout_s=60) is True
    assert ckpt.all_steps() == [1]
    ckpt.close()


def test_save_snapshots_before_an_in_place_update(tmp_path, monkeypatch):
    """The trainer updates parameters, moments and buffers in place; a save
    followed by such an update still writes the values at the save."""
    trainer, state = _tiny_state(ema_decay=0.9)
    batch = next(synthetic_data_iterator(batch_size=4, image_size=32, num_classes=10))
    state, _ = trainer.train_step(state, batch)
    want = _clone(state.state_dict())
    release = _hold_writes(monkeypatch)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state.step, state)
    state, _ = trainer.train_step(state, batch)  # in place, while the write is held
    moments = want["opt_state"]["mu"]
    assert any(not torch.equal(mu, moments[name])
               for name, mu in zip(trainer._param_names, state.opt_state.mu))
    release.set()
    ckpt.close()
    raw = ckpt.restore_raw()
    for key in ("step", "params", "batch_stats", "opt_state", "generators"):
        _assert_trees_equal(raw[key], want[key], key)


def test_resume_json_and_config_beside_the_steps(tmp_path):
    trainer, _ = _tiny_state(checkpoint_dir=str(tmp_path), checkpoint_every_steps=2,
                             log_every_steps=1, num_train_images=12, num_epochs=2,
                             checkpoint_every_epochs=100)
    batches = synth_resumable_iterator(seed=0, batch_size=4, image_size=32, num_classes=10)
    state, _ = trainer.fit(batches, num_steps=5)
    assert trainer.checkpointer.all_steps() == [2, 4, 5]
    stamp = json.loads((tmp_path / "resume.json").read_text())
    assert set(stamp) == {"schema", "step", "epoch", "step_in_epoch", "steps_per_epoch", "seed",
                          "feeder_position", "rng", "saved_unix"}
    assert (stamp["step"], stamp["epoch"], stamp["step_in_epoch"], stamp["steps_per_epoch"],
            stamp["seed"], stamp["feeder_position"]) == (5, 1, 2, 3, 0, 5)
    assert stamp["rng"]["generators"] == ["dropout", "mix", "stochastic_depth"]
    assert "stream_seed(seed, 'dropout')" in stamp["rng"]["derivation"]
    saved = json.loads((tmp_path / "5" / "config.json").read_text())
    assert saved == json.loads(trainer.config.to_json())


# ----------------------------------------------------------------- resume


def _resume_trainer(case, checkpoint_dir=None):
    common = dict(num_classes=10, compute_dtype="float32", global_batch_size=8,
                  num_train_images=64, num_epochs=2, warmup_epochs=0, transpose_images=False,
                  base_lr=0.01, seed=0, ema_decay=0.9, log_every_steps=1,
                  checkpoint_dir=checkpoint_dir)
    if case == "vit":  # dropout and attention dropout (dense path), remat, EMA
        name, size, overrides = "vit_ti_patch16", 32, dict(
            VIT, dropout_rate=0.1, attn_dropout_rate=0.1, remat=True)
    elif case == "cait":  # stochastic depth and dropout, EMA
        name, size, overrides = "cait_xxs_24", 32, dict(
            CAIT, stoch_depth_rate=0.2, dropout_rate=0.1)
    else:  # running statistics, EMA
        name, size, overrides = "botnet_t3", 64, dict(BOTNET)
    model = create_model(name, num_classes=10, image_size=size, seed=0, **overrides)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # a zero head (and zero bn3 scales) would pass no gradient back
        torch.nn.init.normal_(model.head.weight, std=0.05, generator=gen)
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.zero_scale:
                torch.nn.init.uniform_(m.weight, 0.5, 1.5, generator=gen)
    config = TrainConfig(model_name=name, image_size=size, **common)
    return Trainer(config, model=model, device="cpu"), size


@pytest.mark.parametrize("case", ["vit", "cait", "botnet"])
def test_two_steps_restore_two_more_equal_four_steps(case, tmp_path):
    """Bit for bit: the losses, every parameter, moment, EMA entry, buffer
    and generator state after 2 steps, a restore into a fresh trainer and 2
    more steps, against 4 uninterrupted steps."""
    trainer, size = _resume_trainer(case)

    def feed(start):
        return synth_resumable_iterator(seed=0, start_step=start, batch_size=8,
                                        image_size=size, num_classes=10)

    state, history = trainer.fit(feed(0), num_steps=4, state=trainer.init_state())
    want = _clone(state.state_dict())
    first, _ = _resume_trainer(case, str(tmp_path))
    _, head = first.fit(feed(0), num_steps=2, state=first.init_state())
    assert first.checkpointer.all_steps() == [2]
    second, _ = _resume_trainer(case, str(tmp_path))
    restored = second.restore_or_init()
    assert restored.step == 2
    restored, tail = second.fit(feed(restored.step), num_steps=4, state=restored)
    assert [r["step"] for r in head + tail] == [1, 2, 3, 4]
    assert [r["loss"] for r in head + tail] == [r["loss"] for r in history]
    _assert_trees_equal(_clone(restored.state_dict()), want)
    assert second.checkpointer.all_steps() == [2, 4]


# -------------------------------------------------------------- sav_tpu side


def _jax_common(**kw):
    return {**dict(model_name="vit_ti_patch16", num_classes=10, image_size=32,
                   compute_dtype="float32", attention_backend="xla", model_overrides=dict(VIT),
                   global_batch_size=16, num_train_images=64, num_epochs=2, warmup_epochs=0,
                   transpose_images=False, base_lr=0.05, seed=0), **kw}


def _flax_vit_params(num_classes=10, image_size=32, seed=0):
    model = jax_create_model("vit_ti_patch16", num_classes=num_classes, **VIT)
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((1, image_size, image_size, 3)), is_training=False)
    params = jax.tree.map(np.asarray, variables["params"])
    params["head"]["kernel"] = np.random.default_rng(seed + 1).normal(
        0.0, 0.05, params["head"]["kernel"].shape).astype(np.float32)
    return params


def _batches(n, size=32):
    return list(synthetic_data_iterator(batch_size=16, image_size=size, num_classes=10,
                                        seed=11, num_batches=n))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """sav_tpu's Trainer from the drawn params: 2 steps of fit() that write
    an orbax checkpoint at step 2."""
    directory = str(tmp_path_factory.mktemp("sav_tpu_ckpt"))
    params = _flax_vit_params()
    trainer = JaxTrainer(JaxTrainConfig(**_jax_common(checkpoint_dir=directory,
                                                      log_every_steps=3)))
    state = trainer.init_state()
    state = state.replace(params=jax.tree.map(
        lambda n, o: jax.device_put(n, o.sharding), params, state.params))
    state, _ = trainer.fit(iter(_batches(2)), num_steps=2, state=state)
    return {"trainer": trainer, "state": state, "dir": directory, "params": params}


def test_fit_from_a_restored_state_matches_sav_tpu_fit(jax_run, tmp_path):
    """From step 2 to 7 with a log every 3 steps: the same steps run, with
    the same step numbers, and the log windows close at the same steps
    (num_steps is the total, the windows fall on the global step)."""
    jax_state, jax_history = jax_run["trainer"].fit(
        iter(_batches(7)[2:]), num_steps=7, state=jax_run["state"])
    assert int(jax_state.step) == 7

    config = TrainConfig(**_jax_common(checkpoint_dir=str(tmp_path), log_every_steps=3))
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **VIT)
    model.load_state_dict(params_from_flax(jax_run["params"]))
    trainer = Trainer(config, model=model, device="cpu")
    trainer.fit(iter(_batches(2)), num_steps=2, state=trainer.init_state())
    resumed = Trainer(config, model=model, device="cpu")
    state = resumed.restore_or_init()
    assert state.step == 2
    state, history = resumed.fit(iter(_batches(7)[2:]), num_steps=7, state=state)
    assert state.step == 7
    assert [r["step"] for r in history] == [3, 4, 5, 6, 7]
    windows = [r["step"] for r in history if "images_per_sec" in r]
    jax_windows = [r for r in jax_history if "loss" in r]  # less its telemetry record
    assert windows == [r["step"] for r in jax_windows] == [3, 6, 7]
    # The same steps on both sides: the losses agree at each window's end.
    by_step = {r["step"]: r for r in history}
    for ref in jax_windows:
        np.testing.assert_allclose(by_step[ref["step"]]["loss"], ref["loss"], rtol=1e-5, atol=1e-5)


def test_a_sav_tpu_checkpoint_seeds_the_port(jax_run):
    """The reference's orbax checkpoint, read by its restore_params_only and
    converted by params_from_flax: the port's logits are the reference's."""
    jax_trainer = jax_run["trainer"]
    reader = JaxCheckpointer(jax_run["dir"], read_only=True)
    template = {"params": jax_run["params"], "step": np.asarray(2, np.int32)}
    restored = reader.restore_params_only(template, step=2)
    reader.close()
    assert int(restored["step"]) == 2
    params = jax.tree.map(np.asarray, restored["params"])
    x = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_trainer.model.apply({"params": params}, x, is_training=False))
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, backend="xla", **VIT)
    model.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def _flax_trees():
    from test_torch_botnet import small_flax_variables
    from test_torch_cait import small_flax_params

    return {"ViT": lambda: {"params": _flax_vit_params()},
            "CaiT": lambda: {"params": small_flax_params()},
            "BoTNet": lambda: jax.tree.map(np.asarray, small_flax_variables())}


@pytest.mark.parametrize("family", ["ViT", "CaiT", "BoTNet"])
def test_flax_from_params_inverts_params_from_flax(family):
    tree = _flax_trees()[family]()
    back = flax_from_params(params_from_flax(tree), family)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_got) == set(flat_want)
    for path, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], np.asarray(value), err_msg=str(path))
    with pytest.raises(KeyError, match="do not produce"):
        flax_from_params({"not_a_port_key": torch.zeros(1)}, family)


def test_warm_start_32_to_64_matches_sav_tpu(tmp_path, caplog):
    """The same source weights saved by each side at 32² with 10 classes,
    warm-started into a 64² model with 5 classes and an EMA: the position
    table resampled 17 → 65 rows and every other tensor carried as
    sav_tpu's warm_start_from carries it (within 2e-5), the head of another
    width kept fresh with a warning, the EMA equal to the transferred
    weights."""
    params = _flax_vit_params()
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    source = JaxTrainer(JaxTrainConfig(**_jax_common()))
    src_state = source.init_state()
    src_state = src_state.replace(params=jax.tree.map(
        lambda n, o: jax.device_put(n, o.sharding), params, src_state.params))
    ckpt = JaxCheckpointer(jax_dir)
    ckpt.save(0, src_state)
    ckpt.wait()
    ckpt.close()
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **VIT)
    model.load_state_dict(params_from_flax(params))
    port_source = Trainer(TrainConfig(**_jax_common()), model=model, device="cpu")
    writer = Checkpointer(port_dir)
    writer.save(0, port_source.init_state())
    writer.close()

    target = _jax_common(image_size=64, num_classes=5, ema_decay=0.999)
    jax_state = JaxTrainer(JaxTrainConfig(**target)).warm_start_from(jax_dir)
    want = params_from_flax(jax.tree.map(np.asarray, jax.device_get(jax_state.params)))
    trainer = Trainer(TrainConfig(**target), device="cpu")
    fresh = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        state = trainer.warm_start_from(port_dir)
    assert state.step == 0 and state.opt_state.count == 0
    assert trainer.last_warm_start == {"transferred": len(want) - 2, "fresh": 2}
    kept = [r.getMessage() for r in caplog.records if "keeping fresh init" in r.getMessage()]
    assert len(kept) == 2 and all("head." in m for m in kept)
    got = state.model.state_dict()
    assert got["encoder.pos_embed.pos_embed"].shape == (1, 65, 64)
    for name, value in got.items():
        if name.startswith("head."):
            assert torch.equal(value, fresh[name]), name
        else:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, rtol=2e-5,
                                       err_msg=name)
    for ema, param in zip(state.opt_state.ema, state.model.parameters()):
        assert torch.equal(ema, param) and ema.data_ptr() != param.data_ptr()
