"""The CaiT options the port carries or refuses, against sav_tpu's (the helpers
are in test_torch_cait.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.models.cait import CaiT

from test_torch_cait import SMALL, TOL, small_flax_params, small_port_model

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "option,item",
    [({"dropout_rate": 0.1}, None), ({"attn_dropout_rate": 0.1}, None),  # carried
     ({"seq_parallel": "ring"}, "A9"), ({"quant": "int8"}, "A8")],
)
def test_unported_cait_options_raise(option, item, monkeypatch):
    """Each option the port does not carry raises, naming its ROADMAP item.
    The dropout rates are carried: the CaiT builds, its eval forward is
    sav_tpu's, and a train forward at the default backend agrees with the
    dense paths' under the same masks; under attention dropout it is the
    dense paths' (the same bits as ``backend='xla'``), the path sav_tpu
    takes. ``quant`` (A8) is carried: the small CaiT on the int8 arm, QAT
    and serving in f32, against sav_tpu's (test_torch_quant's check; bf16
    and the other families in their own files)."""
    with pytest.raises(TypeError, match="unexpected option"):
        CaiT(10, 32, 1, 1, 2, (8, 8), image_size=32, moe_num_experts=2)
    if item == "A8":
        from test_torch_quant import family_case, quant_family_parity

        case = family_case("cait_xxs_24", SMALL, {"params": small_flax_params()}, 32)
        for quant in ("int8", "int8_serve"):
            quant_family_parity(case, quant, "float32", monkeypatch)
        return
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            CaiT(10, 32, 1, 1, 2, (8, 8), image_size=32, **option)
        return
    from sav_tpu_torch.models.layers import set_dropout_generator

    params = small_flax_params()
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jax_model = jax_create_model("cait_xxs_24", num_classes=10, dtype=jnp.float32,
                                 backend="fused", **SMALL, **option)
    ref = np.asarray(jax_model.apply({"params": params}, x, is_training=False))
    out = {}
    for backend in (None, "xla"):
        model = small_port_model(params, backend=backend, **option)
        set_dropout_generator(model, torch.Generator().manual_seed(0))
        with torch.no_grad():
            np.testing.assert_allclose(model.eval()(torch.from_numpy(x)).numpy(), ref, **TOL)
            out[backend] = model.train()(torch.from_numpy(x)).numpy()
    if "attn_dropout_rate" in option:
        np.testing.assert_array_equal(out[None], out["xla"])
    np.testing.assert_allclose(out[None], out["xla"], **TOL)
    assert np.isfinite(out[None]).all() and np.abs(out[None] - ref).max() > 1e-3
