"""The port's cost model (sav_tpu_torch.obs.costs) against sav_tpu's, on the
CPU, and its peak lookup.

Both walk a flax-named parameter tree: sav_tpu's from its own init, the
port's from the port model's state dict through ``flax_from_params``. The
FLOPs agree to 1e-9 relative (the same sums of the same integer-valued
products, possibly in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.obs import costs as jax_costs
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.obs import costs
from sav_tpu_torch.utils import flops

torch.set_num_threads(2)

VIT = dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8))


def _vit_variables():
    model = jax_create_model("vit_ti_patch16", num_classes=10, **VIT)
    return model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
                      is_training=False)


@functools.cache
def _case(family):
    """(model name, overrides, flax variables, image size); read only."""
    from test_torch_botnet import IMAGE, small_flax_variables
    from test_torch_botnet import SMALL as BOTNET_SMALL
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    if family == "vit":
        return "vit_ti_patch16", VIT, {"params": jax.tree.map(
            np.asarray, _vit_variables()["params"])}, 32
    if family == "cait":
        return "cait_xxs_24", CAIT_SMALL, {"params": small_flax_params()}, 32
    return "botnet_t3", BOTNET_SMALL, small_flax_variables(seed=3), IMAGE


@pytest.mark.parametrize("family", ["vit", "cait", "botnet"])
@pytest.mark.parametrize("batch_size,training", [(16, True), (256, True), (8, False)])
def test_analytic_cost_matches_sav_tpu(family, batch_size, training):
    name, overrides, variables, image = _case(family)
    want = jax_costs.analytic_train_step_cost(variables["params"], batch_size=batch_size,
                                              image_size=image, training=training)
    model = create_model(name, num_classes=10, image_size=image, **overrides)
    flat = params_from_flax(variables if "batch_stats" in variables else variables["params"])
    model.load_state_dict(flat, strict=True)
    got = costs.train_step_cost(model, batch_size=batch_size, image_size=image,
                                training=training)
    assert got.source == "analytic" and got.num_tokens == want.num_tokens
    np.testing.assert_allclose(got.flops, want.flops, rtol=1e-9)
    np.testing.assert_allclose(got.bytes_accessed, want.bytes_accessed, rtol=1e-9)
    assert set(got.attribution) == set(want.attribution)
    for key, share in want.attribution.items():
        np.testing.assert_allclose(got.attribution[key], share, rtol=1e-9, err_msg=key)
    assert got.groups.keys() == want.groups.keys()


def test_model_params_tree_names_the_flax_tree():
    model = create_model("vit_ti_patch16", num_classes=10, image_size=32, **VIT)
    tree = costs.model_params_tree(model)
    want = jax.tree_util.tree_structure(jax.tree.map(np.asarray, _vit_variables()["params"]))
    assert jax.tree_util.tree_structure(tree) == want
    with pytest.raises(ValueError, match="no parameter rules"):
        costs.model_params_tree(torch.nn.Linear(2, 2))


def test_peak_lookup():
    assert costs.resolve_peak_flops(2.5e14) == (2.5e14, "override")
    assert costs.resolve_peak_flops(device="cpu") == (costs.CPU_FAKE_PEAK_FLOPS, "cpu-fake")
    assert flops.per_card_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.per_card_peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert flops.per_card_peak_flops("a card the table does not know") is None
    assert flops.per_card_peak_flops("NVIDIA H100 80GB HBM3", "int4") is None


def test_peak_lookup_reads_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    peak, source = costs.resolve_peak_flops(device="cuda")
    assert peak == 989e12 and source.startswith("device-table: NVIDIA H100 80GB HBM3, bfloat16")
    assert costs.resolve_peak_flops(device="cuda", dtype="float32")[0] == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other GPU")
    assert costs.resolve_peak_flops(device="cuda") == (None, "unknown")


# ------------------------------------------------------ the per-family counts

SMALL_FAMILIES = [
    ("ceit_s", dict(embed_dim=32, num_layers=2, num_heads=2), 32),
    ("cvt-13", dict(embed_dims=(16, 32, 64), num_layers=(1, 2, 2), num_heads=(1, 2, 4)), 64),
    ("tnt_s_patch16", dict(embed_dim=32, inner_ch=12, num_layers=2, num_heads=2,
                           inner_num_heads=2), 32),
    ("mixer_s_patch16", dict(embed_dim=32, num_layers=2, tokens_hidden_ch=8,
                             channels_hidden_ch=64), 32),
    ("vit_moe_s_patch16_e8", dict(embed_dim=64, num_layers=2, num_heads=4, patch_shape=(8, 8),
                                  moe_num_experts=4, moe_every=2), 32),
]
FULL_WIDTH = ["ceit_s", "cvt-13", "tnt_s_patch16", "mixer_b_patch16"]


def _forward(model, *, batch_size: int, image_size: int) -> float:
    """The analytic count of one forward."""
    return costs.train_step_cost(model, batch_size=batch_size, image_size=image_size,
                                 training=False).flops


def _counted_forward(model, batch: int, size: int) -> float:
    """FlopCounterMode's FLOPs of one dense-path forward."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, size, size, 3)).astype(np.float32))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.eval()(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("name,overrides,size", SMALL_FAMILIES,
                         ids=[case[0] for case in SMALL_FAMILIES])
def test_family_count_matches_the_flop_counter_small(name, overrides, size):
    model = create_model(name, num_classes=10, image_size=size, backend="xla", **overrides)
    want = _counted_forward(model, 2, size)
    got = _forward(model, batch_size=2, image_size=size)
    assert got == pytest.approx(want, rel=0.01)
    cost = costs.train_step_cost(model, batch_size=2, image_size=size)
    assert cost.source == "analytic" and cost.flops == pytest.approx(3 * got, rel=1e-12)
    assert sum(cost.attribution.values()) == pytest.approx(1.0)


@pytest.mark.parametrize("name", FULL_WIDTH)
def test_family_count_matches_the_flop_counter_full_width(name):
    """Batch 1 of CeiT-S, CvT-13, TNT-S and Mixer-B/16 at 224²."""
    model = create_model(name, num_classes=1000, image_size=224, backend="xla")
    assert _forward(model, batch_size=1, image_size=224) == pytest.approx(
        _counted_forward(model, 1, 224), rel=0.01)


def test_cvt_stage_hand_count():
    """A CvT whose stages hold 1, 2 and 1 blocks, counted by hand for the
    two-block stage: grid 8 × 8 after its 3×3/2 embedding of 16 × 16 × 16,
    width 32, 2 heads of 16, K/V strided to 4 × 4, FF 4×, batch 3."""
    model = create_model("cvt-13", num_classes=10, image_size=64, backend="xla",
                         embed_dims=(16, 32, 64), num_layers=(1, 2, 1), num_heads=(1, 2, 4))
    b, side, c, d = 3, 8, 16, 32
    q, kv = side * side, 4 * 4
    block = (
        2 * b * q * 9 * d + 2 * (2 * b * kv * 9 * d)  # depthwise 3×3: q at stride 1, k/v at 2
        + 2 * b * q * d * d + 2 * (2 * b * kv * d * d)  # pointwise projections
        + 4 * b * 2 * q * kv * 16  # QKᵀ and AV, 2 heads of 16
        + 2 * b * q * d * d  # output merge
        + 2 * (2 * b * q * d * 4 * d)  # FF
    )
    stage = 2 * b * q * 9 * c * d + 2 * block  # the 3×3/2 conv embedding, then two blocks
    tally = costs._Tally()
    costs._count_cvt(model, b, 64, tally)
    assert tally.by_group["stages_1"] == stage


def test_moe_count_is_the_routed_slots_and_the_router():
    model = create_model("vit_moe_s_patch16_e8", num_classes=10, image_size=32,
                         **SMALL_FAMILIES[-1][1])
    dense = create_model("vit_ti_patch16", num_classes=10, image_size=32, embed_dim=64,
                         num_layers=2, num_heads=4, patch_shape=(8, 8))
    b, tokens, d = 5, 17, 64
    moe = model.encoder.blocks[1].ff
    e, _, hidden = moe.experts_w1.shape
    slots = moe.capacity(tokens)
    assert slots == max(2, -(-int(1.25 * 2 * tokens) // e))
    # The MoE block in place of the second block's FF: the router over every
    # token, each expert's two matmuls over its slots of every row.
    routed = 2 * b * tokens * d * e + e * 2 * b * slots * 2 * d * hidden
    ff = 2 * b * tokens * 2 * d * hidden
    got = _forward(model, batch_size=b, image_size=32)
    assert got == pytest.approx(_forward(dense, batch_size=b, image_size=32)
                                - ff + routed, rel=1e-12)
