"""Four f32 train steps of a small CaiT against sav_tpu's Trainer, and the
decay mask on the CaiT tree (the helpers are in test_torch_train.py)."""

import jax
import numpy as np
import torch

from sav_tpu.train import optimizer as jax_optimizer
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import optimizer as port_optimizer

from test_torch_train import _four_steps_against_sav_tpu

torch.set_num_threads(2)


def test_four_cait_train_steps_match_sav_tpu():
    """The CaiT slice as a whole: 4 f32 steps of the small CaiT (2
    talking-heads layers, 1 class-attention layer) at stochastic depth 0
    (jax.random draws cannot be matched), LayerScale and head drawn so that
    the trunk's gradients count."""
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    _four_steps_against_sav_tpu("cait_xxs_24", CAIT_SMALL, small_flax_params())


def test_weight_decay_mask_on_the_cait_tree_matches_sav_tpu():
    """By flax path and by port name the same leaves decay: the [H, H]
    mixing kernels (rank 2) and the class-attention projections do, the
    LayerScale scales (rank 1) and the CLS token do not."""
    from test_torch_cait import SMALL as CAIT_SMALL
    from test_torch_cait import small_flax_params

    params = small_flax_params()
    flax_mask = jax_optimizer.weight_decay_mask(params)
    shaped = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), flax_mask, params)
    want = {name: bool(arr.reshape(-1)[0]) for name, arr in params_from_flax(shaped).items()}
    model = create_model("cait_xxs_24", num_classes=10, image_size=32, **CAIT_SMALL)
    got = port_optimizer.weight_decay_mask(model.named_parameters())
    assert got == want
    assert got["blocks.0.attn.pre_softmax.kernel"] and got["blocks.0.attn.post_softmax.kernel"]
    assert all(got[f"ca_blocks.0.attn.to_{p}"] for p in ("q", "k", "v", "out"))
    assert not got["blocks.0.ls1.scale"] and not got["ca_blocks.0.ls2.scale"] and not got["cls"]
