"""Four f32 Trainer steps of a small CeiT against sav_tpu's (the helpers are in
test_torch_ceit.py)."""

import numpy as np
import torch

from test_torch_ceit import IMAGE, SMALL, small_flax_variables, small_port_model, variables

torch.set_num_threads(2)


def test_four_ceit_train_steps_match_sav_tpu():
    """The CeiT slice as a whole: 4 f32 steps of the small CeiT at the fused
    backend through sav_tpu's Trainer and the port's, from the drawn head
    and running statistics (see tests/test_torch_train.py). LeFF's expand
    and project biases each feed a train-mode BatchNorm, which subtracts
    them again with the batch mean: their gradients are 0 in exact
    arithmetic and f32 noise on both sides (shown here on a train-mode
    backward), so their values after Adam are noise and are held near 0
    instead. The last block's LeFF reaches no logit (only the CLS tokens
    are read after it, and LeFF passes CLS through), so its gradients are
    exactly 0 on both sides and its parameters are compared as the rest."""
    from test_torch_train import _four_steps_against_sav_tpu

    variables = small_flax_variables(seed=3)
    last = SMALL["num_layers"] - 1
    zero_grad = tuple(f"blocks.{i}.leff.{n}.bias" for i in range(last)
                      for n in ("expand", "project"))
    model = small_port_model(variables).train()
    x = np.random.default_rng(12).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    largest = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        grad = float(p.grad.abs().max())
        if name.startswith(f"blocks.{last}.leff."):
            assert grad == 0.0, name
        else:
            assert (grad < 1e-6 * largest) == (name in zero_grad), (name, grad)
    _four_steps_against_sav_tpu("ceit_s", SMALL, variables["params"], image_size=IMAGE,
                                batch_stats=variables["batch_stats"], base_lr=0.02,
                                zero_grad_params=zero_grad)
