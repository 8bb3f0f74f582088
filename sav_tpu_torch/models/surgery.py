"""Parameter surgery: resolution transfer of the position table (port of
``sav_tpu/models/surgery.py``).

The ViT/DeiT fine-tuning recipe (pretrain at 224², fine-tune at 384²)
resamples the learned absolute position table bicubically to the new token
grid. Works on any port ``state_dict`` holding ``AddAbsPosEmbed`` tables
(ViT's ``encoder.pos_embed.pos_embed``, CaiT's ``pos_embed.pos_embed``).

``jax.image.resize(..., 'bicubic')`` is Keys' cubic with a = −0.5,
antialiased when it shrinks. ``F.interpolate(mode='bicubic')`` uses
a = −0.75 unless ``antialias=True``, which switches it to a = −0.5 and the
same antialiased filter: only that form agrees with ``sav_tpu``, up and
down (``tests/test_torch_surgery.py`` pins both).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

POS_EMBED_KEY = "pos_embed"


def _has_cls(length: int) -> bool:
    """Infer a leading CLS slot from the token count: k² → pure grid,
    1 + k² → CLS + grid (the two are never ambiguous for k ≥ 1)."""
    if math.isqrt(length) ** 2 == length:
        return False
    if math.isqrt(length - 1) ** 2 == length - 1:
        return True
    raise ValueError(f"token count {length} is neither k² nor 1+k²")


def resize_pos_embed_table(table: torch.Tensor, new_len: int) -> torch.Tensor:
    """Resample a ``[1, L, D]`` position table to ``[1, new_len, D]``.

    The (square) patch grid is resized bicubically in f32; a leading CLS
    position (inferred from the token count: k² or 1 + k²) is carried over
    unchanged. The result has the table's dtype and device.
    """
    if table.ndim != 3 or table.shape[0] != 1:
        raise ValueError(f"expected [1, L, D] table, got {tuple(table.shape)}")
    if table.shape[1] == new_len:
        return table
    has_cls = _has_cls(table.shape[1])
    cls_part = table[:, :1] if has_cls else table[:, :0]
    grid_part = table[:, 1:] if has_cls else table
    grid_new = new_len - cls_part.shape[1]
    g_old = math.isqrt(grid_part.shape[1])
    g_new = math.isqrt(grid_new)
    if g_new * g_new != grid_new:
        raise ValueError(f"non-square grids: {grid_part.shape[1]} -> {grid_new} tokens")
    dim = table.shape[-1]
    grid = grid_part.reshape(1, g_old, g_old, dim).permute(0, 3, 1, 2).float()
    resized = F.interpolate(
        grid, size=(g_new, g_new), mode="bicubic", align_corners=False, antialias=True
    )
    resized = resized.permute(0, 2, 3, 1).reshape(1, grid_new, dim).to(table.dtype)
    return torch.cat([cls_part, resized], dim=1)


def adapt_pos_embeds(state_dict: dict, target_state_dict: dict) -> dict:
    """``state_dict`` with every table whose key ends in ``pos_embed``
    resized to the shape of the same key in ``target_state_dict`` (e.g. the
    state dict of the model built at the new resolution). Every other entry,
    and a table whose shape already matches, passes through unchanged."""
    adapted = {}
    for key, value in state_dict.items():
        target = target_state_dict.get(key)
        if (
            key.split(".")[-1] == POS_EMBED_KEY
            and target is not None
            and tuple(target.shape) != tuple(value.shape)
        ):
            value = resize_pos_embed_table(value, target.shape[1])
        adapted[key] = value
    return adapted
