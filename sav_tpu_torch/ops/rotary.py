"""Fixed sinusoidal and rotary position embeddings (port of
``sav_tpu/ops/rotary.py``).

The frequencies are RoPE's, ``inv_freq_i = 10000 ** (-2i / dim)`` in f32,
each repeated twice along the feature axis so that the tables pair with
:func:`rotate_every_two`. :func:`apply_rotary_pos_emb` casts the f32 tables
to the activation dtype and computes ``x·cos + rot(x)·sin`` op by op in that
dtype: in bf16 each product and the sum round, which is what XLA does with
the same expression on the CPU (``tests/test_torch_rotary.py`` holds the two
bit for bit).
"""

from __future__ import annotations

from typing import Optional

import torch


def fixed_positional_embedding(seq_len: int, dim: int, dtype=torch.float32,
                               device: Optional[torch.device] = None) -> tuple:
    """Sinusoidal ``(sin, cos)`` tables of shape ``[seq_len, dim]`` each,
    computed in f32 on ``device`` and cast to ``dtype``."""
    if dim % 2 != 0:
        raise ValueError(f"rotary dim must be even, got {dim}")
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv_freq = 1.0 / (10000 ** exponents)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq).repeat_interleave(2, dim=-1)  # [L, dim]
    return torch.sin(freqs).to(dtype), torch.cos(freqs).to(dtype)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """``(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)`` along the last axis."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rotary_pos_emb(x: torch.Tensor, sincos) -> torch.Tensor:
    """RoPE on ``x: [..., seq_len, dim]`` or ``[B, seq_len, heads, dim]``
    (the tables broadcast over the heads), from the ``[seq_len, dim]``
    tables of :func:`fixed_positional_embedding`, cast to ``x``'s dtype
    before the products."""
    sin, cos = sincos
    if x.ndim == 4:  # [B, L, H, D]
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    sin = sin.to(x.dtype)
    cos = cos.to(x.dtype)
    return x * cos + rotate_every_two(x) * sin
