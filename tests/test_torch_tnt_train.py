"""Four f32 Trainer steps of a small TNT against sav_tpu's (the helpers are in
test_torch_tnt.py)."""

import torch

from test_torch_tnt import IMAGE, small, small_flax_params

torch.set_num_threads(2)


def test_four_tnt_train_steps_match_sav_tpu():
    """The TNT slice as a whole: 4 f32 steps of the small TNT-S-like model
    (inner heads of 6) at the fused backend through sav_tpu's Trainer and
    the port's (see tests/test_torch_train.py)."""
    from test_torch_train import _four_steps_against_sav_tpu

    _four_steps_against_sav_tpu("tnt_s_patch16", small(6), small_flax_params(6, seed=3),
                                image_size=IMAGE)
