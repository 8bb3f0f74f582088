"""Four f32 Trainer steps of a small CvT against sav_tpu's (the helpers are in
test_torch_cvt.py)."""

import torch

from test_torch_cvt import IMAGE, SMALL, small_flax_variables, variables

torch.set_num_threads(2)


def test_four_cvt_train_steps_match_sav_tpu():
    """The CvT slice as a whole: 4 f32 steps of the small CvT at the fused
    backend through sav_tpu's Trainer and the port's, from the drawn head
    and running statistics (see tests/test_torch_train.py)."""
    from test_torch_train import _four_steps_against_sav_tpu

    variables = small_flax_variables(seed=3)
    _four_steps_against_sav_tpu("cvt-13", SMALL, variables["params"], image_size=IMAGE,
                                batch_stats=variables["batch_stats"], base_lr=0.02)
