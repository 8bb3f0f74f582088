"""The small CeiT at both int8 arms against sav_tpu's, through
``quant_family_parity`` (the helpers are in test_torch_ceit.py)."""

import pytest
import torch

from test_torch_ceit import IMAGE, SMALL, small_flax_variables

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_serve"])
def test_small_ceit_int8_arms_match_sav_tpu(quant, dtype, monkeypatch):
    """The small CeiT on the int8 arm against sav_tpu's, QAT and serving,
    f32 and bf16 (test_torch_quant.quant_family_parity): top-1 equal,
    logits within 0.1 x their scale, the activation codes as sav_tpu's."""
    from test_torch_quant import family_case, quant_family_parity

    quant_family_parity(family_case("ceit_s", SMALL, small_flax_variables(), IMAGE, images=2), quant, dtype, monkeypatch)
