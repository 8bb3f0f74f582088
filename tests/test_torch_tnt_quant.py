"""The small TNT at both int8 arms against sav_tpu's, through
``quant_family_parity`` (the helpers are in test_torch_tnt.py)."""

import pytest
import torch

from test_torch_tnt import IMAGE, small, small_flax_params

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_serve"])
def test_small_tnt_int8_arms_match_sav_tpu(quant, dtype, monkeypatch):
    """The small TNT (inner head dim 6) on the int8 arm against sav_tpu's, QAT and serving,
    f32 and bf16 (test_torch_quant.quant_family_parity): top-1 equal,
    logits within 0.1 x their scale, the activation codes as sav_tpu's."""
    from test_torch_quant import family_case, quant_family_parity

    quant_family_parity(family_case("tnt_s_patch16", small(6), {"params": small_flax_params(6)}, IMAGE, images=2), quant, dtype, monkeypatch)
