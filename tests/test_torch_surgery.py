"""The port's position-table surgery (sav_tpu_torch.models.surgery) against
sav_tpu's, on the CPU, from the same numpy tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sav_tpu.models import surgery as jax_surgery
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models import surgery

torch.set_num_threads(2)

# f32 resampling: the two libraries sum the 4 × 4 bicubic taps in
# different orders.
TOL = 1e-5


def _table(length, dim=32, seed=0):
    return np.random.default_rng(seed).standard_normal((1, length, dim)).astype(np.float32)


@pytest.mark.parametrize(
    "old,new",
    [
        (197, 577),  # ViT-B/16 224² → 384², CLS slot carried over
        (196, 576),  # no CLS slot (CaiT's table)
        (577, 197),  # down: antialiased on both sides
    ],
)
def test_resize_matches_sav_tpu(old, new):
    table = _table(old)
    want = np.asarray(jax_surgery.resize_pos_embed_table(jnp.asarray(table), new))
    got = surgery.resize_pos_embed_table(torch.from_numpy(table), new)
    assert got.shape == (1, new, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if old % 2:  # the CLS row passes through bit for bit
        assert torch.equal(got[:, 0], torch.from_numpy(table)[:, 0])


def test_plain_bicubic_interpolate_would_not_match():
    """torch's bicubic without antialias uses a = −0.75; jax.image.resize
    uses Keys' a = −0.5. Upsampling 14 → 24 they differ by ~0.3, far over the
    tolerance: the port must use the antialiased form."""
    table = _table(196, seed=1)
    want = np.asarray(jax_surgery.resize_pos_embed_table(jnp.asarray(table), 576))
    grid = torch.from_numpy(table).reshape(1, 14, 14, 32).permute(0, 3, 1, 2)
    plain = F.interpolate(grid, size=(24, 24), mode="bicubic", align_corners=False)
    plain = plain.permute(0, 2, 3, 1).reshape(1, 576, 32).numpy()
    assert np.abs(plain - want).max() > 0.1
    np.testing.assert_allclose(
        surgery.resize_pos_embed_table(torch.from_numpy(table), 576).numpy(), want,
        atol=TOL, rtol=TOL,
    )


def test_adapt_pos_embeds_changes_only_the_table():
    small = dict(embed_dim=64, num_layers=2, num_heads=2, patch_shape=(8, 8))
    source = create_model("vit_ti_patch16", image_size=32, seed=0, **small).state_dict()
    target = create_model("vit_ti_patch16", image_size=64, seed=1, **small).state_dict()
    adapted = surgery.adapt_pos_embeds(source, target)
    assert set(adapted) == set(source)
    key = "encoder.pos_embed.pos_embed"
    assert source[key].shape == (1, 17, 64) and adapted[key].shape == (1, 65, 64)
    want = jax_surgery.resize_pos_embed_table(jnp.asarray(source[key].numpy()), 65)
    np.testing.assert_allclose(adapted[key].numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for name, value in source.items():
        if name != key:
            assert adapted[name] is value, name
    model = create_model("vit_ti_patch16", image_size=64, **small)
    model.load_state_dict(adapted, strict=True)


def test_bad_grids_raise():
    with pytest.raises(ValueError, match="non-square"):
        surgery.resize_pos_embed_table(torch.zeros(1, 197, 8), 501)
    with pytest.raises(ValueError, match="neither"):
        surgery.resize_pos_embed_table(torch.zeros(1, 200, 8), 197)
    with pytest.raises(ValueError, match=r"\[1, L, D\]"):
        surgery.resize_pos_embed_table(torch.zeros(197, 8), 577)
