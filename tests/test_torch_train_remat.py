"""Four f32 train steps of a small remat ViT at backend pallas against
sav_tpu's Trainer (the helpers are in test_torch_train.py)."""

import torch

from test_torch_train import SMALL, _flax_params, _four_steps_against_sav_tpu

torch.set_num_threads(2)


def test_four_remat_flash_train_steps_match_sav_tpu():
    """The ViT-B/16@384 fine-tune path at small size: the same 2-layer ViT at
    backend 'pallas' (the flash kernels' plain versions here, the Pallas
    flash kernels in interpret mode there) with remat on both sides."""
    _four_steps_against_sav_tpu("vit_ti_patch16", SMALL, _flax_params(), backend="pallas",
                                model_overrides={"remat": True})
