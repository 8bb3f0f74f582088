"""The small MLP-Mixer at both int8 arms against sav_tpu's, through
``quant_family_parity`` (the helpers are in test_torch_mixer.py)."""

import pytest
import torch

from test_torch_mixer import IMAGE, SMALL, params

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8_serve"])
def test_small_mixer_int8_arms_match_sav_tpu(quant, dtype, monkeypatch, params):
    """The small MLP-Mixer on the int8 arm against sav_tpu's, QAT and serving,
    f32 and bf16 (test_torch_quant.quant_family_parity): top-1 equal,
    logits within 0.1 x their scale, the activation codes as sav_tpu's."""
    from test_torch_quant import family_case, quant_family_parity

    quant_family_parity(family_case("mixer_s_patch16", SMALL, {"params": params}, IMAGE), quant, dtype, monkeypatch)
