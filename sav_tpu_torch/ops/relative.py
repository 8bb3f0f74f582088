"""2-D relative position logits for BoTNet attention (port of
:mod:`sav_tpu.ops.relative`).

Per-axis 1-D relative logits from learned ``(2L-1, d)`` tables, converted
relative → absolute with the pad/reshape/slice trick (no gather), combined as
``rel_h + rel_w``. This is the bias of the dense (``'xla'``) path; the
kernels' path builds the same bias from compact per-axis logits
(:func:`sav_tpu_torch.ops.flash_attention.compact_to_absolute`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """Relative-indexed logits ``[..., L, 2L-1]`` → absolute ``[..., L, L]``:
    ``out[..., i, j] == x[..., i, j - i + L - 1]``."""
    *lead, length, rel = x.shape
    if rel != 2 * length - 1:
        raise ValueError(f"expected last dim {2 * length - 1}, got {rel}")
    x = F.pad(x, (0, 1))  # [..., L, 2L]
    x = x.reshape(*lead, length * 2 * length)
    x = F.pad(x, (0, length - 1))  # [..., 2L² + L - 1]
    x = x.reshape(*lead, length + 1, 2 * length - 1)
    return x[..., :length, length - 1:]


def _relative_logits_1d(q: torch.Tensor, rel_k: torch.Tensor) -> torch.Tensor:
    """``q: [B, h, X, Y, d]``, ``rel_k: [2Y-1, d]`` → f32 ``[B, h, X, Y, Y]``.
    The product is taken in f32 from the operands as given (a product of two
    bf16 values is exact in f32), as ``preferred_element_type=f32`` does."""
    logits = torch.einsum("bhxyd,md->bhxym", q.float(), rel_k.float())
    return rel_to_abs(logits)


def relative_logits_2d(q: torch.Tensor, rel_k_h: torch.Tensor, rel_k_w: torch.Tensor) -> torch.Tensor:
    """Full 2-D relative position logits.

    Args:
      q: queries on the feature-map grid, ``[B, heads, H, W, d]``.
      rel_k_h: ``[2H-1, d]`` height-relative table.
      rel_k_w: ``[2W-1, d]`` width-relative table.

    Returns:
      f32 ``[B, heads, H, W, H, W]`` with entry ``[b, n, x, y, X, Y] =
      q[b,n,x,y]·rel_k_h[X-x+H-1] + q[b,n,x,y]·rel_k_w[Y-y+W-1]``.
    """
    b, h, height, width, _ = q.shape
    rel_w = _relative_logits_1d(q, rel_k_w)  # [b, n, x, y, Y]
    rel_w = rel_w[:, :, :, :, None, :].expand(b, h, height, width, height, width)
    rel_h = _relative_logits_1d(q.transpose(2, 3), rel_k_h)  # [b, n, y, x, X]
    rel_h = rel_h.permute(0, 1, 3, 2, 4)[..., None].expand(b, h, height, width, height, width)
    return rel_w + rel_h
