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
