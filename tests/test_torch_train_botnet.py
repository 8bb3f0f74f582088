"""Four f32 train steps of a small BoTNet against sav_tpu's Trainer (the helpers
are in test_torch_train.py)."""

import torch

from test_torch_train import _four_steps_against_sav_tpu

torch.set_num_threads(2)


def test_four_botnet_train_steps_match_sav_tpu():
    """The BoTNet slice as a whole: 4 f32 steps of the small BoTNet (every
    stage one block, 64², one BoTBlock over 4×4) at backend 'pallas', from
    drawn bn3 scales, head and running statistics; the running statistics
    are updated in each train step and compared after the last. Base lr
    0.02: BatchNorm at batch 16 with bn3 scales near 1 makes the loss jump
    at 0.05."""
    from test_torch_botnet import IMAGE, small_flax_variables
    from test_torch_botnet import SMALL as BOTNET_SMALL

    variables = small_flax_variables(seed=3)
    _four_steps_against_sav_tpu("botnet_t3", BOTNET_SMALL, variables["params"], backend="pallas",
                                image_size=IMAGE, batch_stats=variables["batch_stats"],
                                base_lr=0.02)
