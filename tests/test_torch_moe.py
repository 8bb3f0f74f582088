"""The port's mixture-of-experts feed-forward (models/layers/moe.py), the MoE
ViT and the trainer's sown losses against sav_tpu's, on the CPU.

Both sides take the same flax parameters (the port's through
``params_from_flax``) and the same numpy inputs. Tolerances are those of
tests/test_fused_attention.py: f32 forward 2e-5, gradients 1e-4 of each
tensor's largest entry / 5e-4 relative, bf16 3e-2; the models' logits
tests/test_torch_vit.py's 1e-4 (XLA:CPU and torch sum the conv and the
matmuls in other orders across two layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.layers.moe import MoEFFBlock as JaxMoEFFBlock
from sav_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import flax_from_params, params_from_flax
from sav_tpu_torch.models import create_model, model_names
from sav_tpu_torch.models.layers import MoEFFBlock, cast_for_compute, sow_losses
from sav_tpu_torch.obs import costs
from sav_tpu_torch.serve.engine import build_infer_fn
from sav_tpu_torch.train import optimizer as port_optimizer

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 3e-2
TOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_LARGEST = 5e-4, 1e-4
# embed 64, 2 layers (block 1 routed), 4 heads of 16, patch 8 at 32x32: L = 17;
# 4 experts, top 2: 11 slots an expert and row.
SMALL = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8), moe_num_experts=4,
             moe_top_k=2)
LOSS_NAMES = ("moe_aux_loss", "moe_router_z_loss")


def assert_grad_close(got, want, name):
    atol = GRAD_ATOL_OF_LARGEST * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def block_params(dim=64, experts=4, seed=0, router_std=0.5):
    """A flax MoEFFBlock's params: sav_tpu's init, the router drawn at
    ``router_std`` (at its init's 0.02 every token routes near a tie) and
    the zero biases drawn, from numpy seeds."""
    block = JaxMoEFFBlock(num_experts=experts)
    variables = block.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 17, dim)),
                           is_training=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed + 1)
    params["router"] = rng.normal(0.0, router_std, params["router"].shape).astype(np.float32)
    for name in ("experts_b1", "experts_b2"):
        params[name] = rng.normal(0.0, 0.1, params[name].shape).astype(np.float32)
    return params


def run_jax_block(params, x, **kw):
    """sav_tpu's block in training mode: output and sown losses by name."""
    block = JaxMoEFFBlock(num_experts=params["router"].shape[1], **kw)
    y, state = block.apply({"params": params}, x, is_training=True, mutable=["losses"])
    losses = {k: float(v[0]) for k, v in state.get("losses", {}).items()}
    return np.asarray(y.astype(jnp.float32)), losses


def port_block(params, **kw):
    block = MoEFFBlock(params["router"].shape[0], params["router"].shape[1], **kw)
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return block.train()


@functools.cache
def small_flax_params(seed=0):
    """The small MoE ViT's params from sav_tpu's init; head (zero) drawn at
    std 0.5, the router at 0.5 and the expert biases at 0.1."""
    model = jax_create_model("vit_ti_patch16", num_classes=10, **SMALL)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)),
                           is_training=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed + 1)
    params["head"]["kernel"] = rng.normal(0.0, 0.5, params["head"]["kernel"].shape).astype(
        np.float32)
    moe = params["Encoder_0"]["block_1"]["MoEFFBlock_0"]
    moe["router"] = rng.normal(0.0, 0.5, moe["router"].shape).astype(np.float32)
    for name in ("experts_b1", "experts_b2"):
        moe[name] = rng.normal(0.0, 0.1, moe[name].shape).astype(np.float32)
    return params


def small_port_model(**kw):
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **SMALL, **kw)
    model.load_state_dict(params_from_flax(small_flax_params()), strict=True)
    return model


# ------------------------------------------------------------------ block


@pytest.mark.parametrize(
    "case,kw",
    [
        ("default", {}),
        ("drops", {"capacity_factor": 0.5}),
        ("top1", {"top_k": 1}),
        ("no z-loss", {"router_z_loss_weight": 0.0}),
    ],
)
def test_block_output_and_sown_losses_match_sav_tpu(case, kw):
    """Output, the balance loss and the z-loss (absent at weight 0), and
    every gradient of Σ y² plus both losses."""
    params = block_params()
    x = np.random.default_rng(2).standard_normal((3, 17, 64)).astype(np.float32)
    want, want_losses = run_jax_block(params, x, **kw)
    block = port_block(params, **kw)
    xt = torch.from_numpy(x).requires_grad_()
    with sow_losses(block) as sown:
        y = block(xt)
    names = LOSS_NAMES[:len(sown)]
    assert set(names) == set(want_losses)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    for name, loss in zip(names, sown):
        np.testing.assert_allclose(float(loss.detach()), want_losses[name], rtol=F32_TOL, err_msg=name)
    if case == "drops":
        _, gates, _, slots = block.route(xt.detach())
        c = block.capacity(17)
        assert c == 5 and int((slots == 4 * c).sum()) > 5
        # A token both of whose choices were dropped passes 0 on both sides.
        both = (slots == 4 * c).all(dim=-1)
        assert bool(both.any()) and np.abs(want[both.numpy()]).max() == 0.0

    def jax_loss(p, x):
        y, state = JaxMoEFFBlock(num_experts=4, **kw).apply(
            {"params": p}, x, is_training=True, mutable=["losses"])
        return jnp.sum(y ** 2) + sum(v[0] for v in state["losses"].values())

    grads, dx = jax.grad(jax_loss, argnums=(0, 1))(params, x)
    ((y ** 2).sum() + sum(sown)).backward()
    for name, p in block.named_parameters():
        assert_grad_close(p.grad.numpy(), np.asarray(grads[name]), name)
    assert_grad_close(xt.grad.numpy(), np.asarray(dx), "inputs")
    assert float(block.router.grad.abs().max()) > 1e-3


def test_tied_router_probabilities_pick_the_lower_experts():
    """A zero router gives every expert probability 1/E exactly: each token
    picks experts 0 and 1 (sav_tpu's jax.lax.top_k order), the first 11
    tokens fill expert 0's and 1's slots and the rest are dropped, on both
    sides."""
    params = block_params()
    params["router"] = np.zeros_like(params["router"])
    x = np.random.default_rng(3).standard_normal((2, 17, 64)).astype(np.float32)
    want, want_losses = run_jax_block(params, x)
    block = port_block(params)
    probs, gates, experts, slots = block.route(torch.from_numpy(x))
    assert torch.equal(probs, torch.full_like(probs, 0.25))
    assert torch.equal(experts, torch.tensor([0, 1]).expand(2, 17, 2))
    c = block.capacity(17)
    assert c == 11
    kept = torch.arange(17) < c
    assert torch.equal(slots[..., 0], torch.where(kept, torch.arange(17), 4 * c).expand(2, 17))
    assert torch.equal(gates[..., 0], torch.where(kept, 0.5, 0.0).expand(2, 17))
    with sow_losses(block) as sown, torch.no_grad():
        y = block(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(want[:, c:]).max() == 0.0 and np.abs(want[:, :c]).min() > 0.0
    np.testing.assert_allclose([float(v) for v in sown],
                               [want_losses[n] for n in LOSS_NAMES], rtol=F32_TOL)


def test_slots_fill_first_choices_before_second_ones():
    """Slot-major placement: in an expert's buffer every token that chose it
    first comes before any that chose it second, each in token order."""
    params = block_params(seed=4)
    x = np.random.default_rng(5).standard_normal((1, 17, 64)).astype(np.float32)
    block = port_block(params)
    _, _, experts, slots = block.route(torch.from_numpy(x))
    c = block.capacity(17)
    for e in range(4):
        order = [(choice, t) for choice in range(2) for t in range(17)
                 if experts[0, t, choice] == e]
        got = [int(slots[0, t, choice]) for choice, t in order]
        assert got == [e * c + i if i < c else 4 * c for i in range(len(order))]


def test_bf16_block_matches_sav_tpu_with_an_f32_router():
    """In bf16 the router stays f32 (F32_TENSORS) and the gates are rounded
    to bf16 before the combine; outputs within the bf16 tolerance."""
    params = block_params(seed=6)
    x = np.random.default_rng(7).standard_normal((2, 17, 64)).astype(np.float32)
    want, _ = run_jax_block(params, jnp.asarray(x).astype(jnp.bfloat16), dtype=jnp.bfloat16)
    block = cast_for_compute(port_block(params), torch.bfloat16)
    assert block.router.dtype == torch.float32 and block.experts_w1.dtype == torch.bfloat16
    with torch.no_grad():
        y = block(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def test_eval_sows_nothing_and_two_backward_runs_are_bit_equal():
    params = block_params(seed=8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 17, 64)).astype(np.float32))
    block = port_block(params)
    with sow_losses(block) as sown, torch.no_grad():
        block.eval()(x)
    assert sown == [] and block.sink is None
    block.train()
    runs = []
    for _ in range(2):
        block.zero_grad()
        with sow_losses(block) as sown:
            y = block(x)
        ((y ** 2).sum() + sum(sown)).backward()
        runs.append([p.grad.clone() for p in block.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------------------------ models


def test_remat_gives_the_gradients_and_losses_without_remat():
    """Under remat the MoE block is recomputed in the backward: the sown
    losses are counted once, and every gradient (through the losses too)
    is the one without remat."""
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    runs = []
    for remat in (False, True):
        model = small_port_model(backend="fused", remat=remat).train()
        with sow_losses(model) as sown:
            logits = model(x)
        assert len(sown) == 2
        ((logits ** 2).sum() + sum(sown)).backward()
        assert len(sown) == 2
        runs.append({n: p.grad for n, p in model.named_parameters()})
    for name, grad in runs[0].items():
        np.testing.assert_allclose(runs[1][name].numpy(), grad.numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=name)
    assert float(runs[0]["encoder.blocks.1.ff.router"].abs().max()) > 1e-4


def test_a_served_row_does_not_depend_on_the_other_rows():
    """Each batch row routes alone (a row is a group with its own
    capacity): a row's logits are the same alone and beside other rows."""
    model = small_port_model(backend="fused").eval()
    infer = build_infer_fn(model, torch.float32)
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8))
    others = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    alone = infer(images[:1], torch.ones(1))
    for batch in (images, torch.cat([images[:1], others])):
        together = infer(batch, torch.ones(len(batch)))
        np.testing.assert_allclose(together[:1].numpy(), alone.numpy(), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ interop, registry


def test_interop_round_trip_and_decay_mask_match_sav_tpu():
    """The MoE tree converts both ways exactly, and the same leaves decay
    by flax path and by port name: the router and the rank-2 expert biases
    do, as sav_tpu's rank rule has it."""
    params = small_flax_params()
    state = params_from_flax(params)
    assert state["encoder.blocks.1.ff.experts_w1"].shape == (4, 64, 256)
    back = flax_from_params(state, "ViT")["params"]
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want_mask = {n: bool(a.reshape(-1)[0]) for n, a in params_from_flax(shaped).items()}
    got = port_optimizer.weight_decay_mask(small_port_model().named_parameters())
    assert got == want_mask
    assert all(got[f"encoder.blocks.1.ff.{n}"] for n in
               ("router", "experts_w1", "experts_b1", "experts_w2", "experts_b2"))


def test_registry_moe_entry_matches_sav_tpu_tree_at_full_size():
    """vit_moe_s_patch16_e8 at 224²: six routed blocks (1, 3, ..., 11) of 8
    experts, top 2, 62 slots at L = 197; every tensor has the shape
    sav_tpu's tree converts to; every sav_tpu name is in the registry."""
    fields = JAX_REGISTRY["vit_moe_s_patch16_e8"][1]
    assert (fields["moe_num_experts"], fields["moe_top_k"]) == (8, 2)
    jax_model = jax_create_model("vit_moe_s_patch16_e8", num_classes=1000)
    shapes = jax.eval_shape(
        lambda r: jax_model.init({"params": r}, jnp.zeros((1, 224, 224, 3)), is_training=False),
        jax.random.PRNGKey(0))
    converted = params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                              shapes["params"]))
    model = create_model("vit_moe_s_patch16_e8")
    ours = model.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    routed = [i for i, b in enumerate(model.encoder.blocks) if isinstance(b.ff, MoEFFBlock)]
    assert routed == [1, 3, 5, 7, 9, 11] and model.encoder.blocks[1].ff.capacity(197) == 62
    assert set(JAX_REGISTRY) <= set(model_names())


def test_moe_vit_has_no_analytic_cost():
    """sav_tpu's count charges every expert for every token; the port's
    charges each expert for its capacity's slots of every batch row (E · C
    slots a row) and the router for every token, the rest as sav_tpu's
    ViT count (no longer refused)."""
    model = create_model("vit_moe_s_patch16_e8", num_classes=10, image_size=32, **SMALL)
    block = model.encoder.blocks[1].ff
    tokens, b, d = 1 + (32 // 8) ** 2, 4, SMALL["embed_dim"]
    slots = block.capacity(tokens)
    dense = costs.analytic_train_step_cost(costs.model_params_tree(model), batch_size=b,
                                           image_size=32, training=False)
    cost = costs.train_step_cost(model, batch_size=b, image_size=32, training=False)
    routed = [m for m in model.modules() if isinstance(m, MoEFFBlock)]
    e, _, hidden = block.experts_w1.shape
    # Per MoE block: every token's expert matmuls and bias rows out, the
    # capacity's slots' matmuls in.
    per_block = (2.0 * b * tokens * e * (2 * d * hidden + hidden + d)
                 - 2.0 * b * slots * e * 2 * d * hidden)
    assert cost.source == "analytic"
    assert cost.flops == pytest.approx(dense.flops - len(routed) * per_block, rel=1e-12)
def test_train_bench_prints_no_mfu_for_the_moe_vit(capsys):
    import json

    from sav_tpu_torch.train import bench

    overrides = {"num_layers": 2, "embed_dim": 64, "num_heads": 4, "patch_shape": [8, 8]}
    bench.main(["--device", "cpu", "--model", "vit_moe_s_patch16_e8", "--image-size", "32",
                "--num-classes", "10", "--batch-size", "4", "--steps", "1", "--reps", "1",
                "--model-overrides", json.dumps(overrides)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cost_source"] == "analytic" and isinstance(line["mfu"], float)
    model = create_model("vit_moe_s_patch16_e8", num_classes=10, image_size=32, **overrides)
    assert line["step_flops"] == pytest.approx(
        costs.train_step_cost(model, batch_size=4, image_size=32).flops, rel=1e-12)
