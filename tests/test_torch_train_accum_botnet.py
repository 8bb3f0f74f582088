"""Gradient accumulation for a small BoTNet against sav_tpu's scan, its running
statistics threaded through the micro-batches (the helpers are in
test_torch_train_accum.py)."""

import torch

from test_torch_train import _four_steps_against_sav_tpu

torch.set_num_threads(2)


def test_accumulated_botnet_steps_thread_the_running_statistics_as_sav_tpu():
    """The small BoTNet (one block a stage, 64²) at global batch 32 as 2
    micro-batches of 16 (the plain four-step test's batch): each
    micro-batch normalises by its own statistics and updates the running
    ones the next sees (sav_tpu's scan carry); the running statistics
    after 4 steps agree with sav_tpu's. Base lr 0.005 (×32/512)."""
    from test_torch_botnet import IMAGE, small_flax_variables
    from test_torch_botnet import SMALL as BOTNET_SMALL

    variables = small_flax_variables(seed=3)
    _four_steps_against_sav_tpu("botnet_t3", BOTNET_SMALL, variables["params"], backend="xla",
                                image_size=IMAGE, batch_stats=variables["batch_stats"],
                                base_lr=0.005, grad_accum_steps=2, batch_size=32)
