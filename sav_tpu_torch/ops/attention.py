"""Scaled dot-product attention cores and the port's dispatch rule.

Port of :mod:`sav_tpu.ops.attention`. Layout everywhere:
``[batch, length, heads, head_dim]``.

``backend``:
  - ``'fused'`` — the single-pass kernel (:mod:`sav_tpu_torch.ops.fused_attention`);
    raises when the shape exceeds the kernel's shared-memory budget.
  - ``'xla'``   — :func:`dense_attention`, plain PyTorch ops; the counterpart
    of ``sav_tpu``'s ``xla_attention``. Opt-in only: ``auto`` never picks it.
  - ``'pallas'`` — the blocked flash kernels
    (:mod:`sav_tpu_torch.ops.flash_attention`): any sequence length, head
    dims up to 128.
  - ``'auto'``/``None`` — :func:`resolve_attention_backend`: the fused kernel
    wherever it is eligible (when an input requires grad, the CUDA-core
    backward's band counts too: :func:`~sav_tpu_torch.ops.fused_attention.fused_auto_eligible`),
    else the flash kernels, on CPU (their plain
    versions) and on CUDA alike. The TPU tune cache and the TPU's
    dense-logits threshold are not carried over: they record TPU
    measurements.

Head dims: both kernel families are built for multiples of 8, and their
wrappers zero-pad any other head dim to the next one with the scale of the
true head dim (:func:`~sav_tpu_torch.ops.fused_attention.pad_head_dim`;
TNT's inner heads of 6 and 10 run at 8 and 16). The rule below judges a
shape by the padded head dim's budget.

Attention dropout (a ``dropout`` layer on the probabilities, active in
training only) runs on the dense path, as in ``sav_tpu`` (``kernels_ok``):
``auto`` takes ``'xla'`` for such a call and an explicit kernel backend
raises ``ValueError``; no kernel takes dropout.

Gradients: the ``fused`` and ``pallas`` paths differentiate through their
backward kernels (or, with a bias, :func:`dense_recompute_bwd`); the ``xla``
path through PyTorch autograd of its plain ops.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sav_tpu_torch.ops import flash_attention as _flash
from sav_tpu_torch.ops import fused_attention as _fused


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def dense_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    logits_dtype=None,
    dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Attention in plain PyTorch ops, with ``xla_attention``'s numerics: q
    is scaled in its own dtype first, the logits and softmax are in
    ``logits_dtype`` (None = float32), ``dropout`` (when given) applies to
    the probabilities in that dtype, and they are cast to the value dtype
    before PV.

    Args:
      query: ``[..., q_len, heads, head_dim]``.
      key, value: ``[..., kv_len, heads, head_dim]``.
      bias: optional bias broadcastable to ``[..., heads, q_len, kv_len]``.
    """
    if scale is None:
        scale = query.shape[-1] ** -0.5
    logits_dtype = torch.float32 if logits_dtype is None else _as_dtype(logits_dtype)
    # A 0-dim CPU tensor: the scale rounds to q's dtype and reaches a CUDA op as
    # a scalar argument, with no host-to-device copy (legal under graph capture).
    qs = query * torch.tensor(scale, dtype=query.dtype)
    compute = torch.promote_types(query.dtype, logits_dtype)
    logits = torch.einsum(
        "...qhd,...khd->...hqk", qs.to(compute), key.to(compute)
    ).to(logits_dtype)
    if bias is not None:
        logits = logits + bias.to(logits_dtype)
    probs = torch.softmax(logits, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(value.dtype), value)


def dense_recompute_bwd(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor],
    grad: torch.Tensor,
    scale: float,
):
    """Backward of biased attention by dense recompute (port of
    ``_dense_recompute_bwd``, ``sav_tpu/ops/flash_attention.py:547``): f32
    scores plus the f32 bias, f32 softmax; P, dO and V cast to the query
    dtype before their products, ``ds = P·(dP − Σ P·dP)`` in f32 and cast
    before ``dq``/``dk``. The bias gradient is ``ds`` summed over the bias's
    broadcast axes. Returns ``(dq, dk, dv, dbias)``; dbias is None without a
    bias."""
    mm = query.dtype

    def product(spec, a, b):
        return torch.einsum(spec, a.to(mm).float(), b.to(mm).float())

    s = product("bqhd,bkhd->bhqk", query, key) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    dv = product("bhqk,bqhd->bkhd", p, grad)
    dp = product("bqhd,bkhd->bhqk", grad, value)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = product("bhqk,bkhd->bqhd", ds, key) * scale
    dk = product("bhqk,bqhd->bkhd", ds, query) * scale
    dbias = None
    if bias is not None:
        axes = [a for a in range(ds.ndim) if bias.shape[a] == 1 and ds.shape[a] != 1]
        dbias = (ds.sum(dim=axes, keepdim=True) if axes else ds).to(bias.dtype)
    return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype), dbias


def resolve_attention_backend(
    q_len: int,
    kv_len: int,
    dim: int,
    *,
    dtype=torch.bfloat16,
    requested: Optional[str] = None,
    backward: bool = False,
    dropout: bool = False,
) -> str:
    """The port's rule on static shapes, returning ``'fused'``, ``'pallas'``
    or ``'xla'``: ``auto`` means the fused kernel inside its band (with
    ``backward=True``, the backward kernel's band too), else the flash
    kernels, and raises only where those do not take the head dim;
    ``fused``, ``pallas`` and ``xla`` pass through. A call with attention
    ``dropout`` takes ``xla`` under ``auto``, and an explicit kernel
    backend raises."""
    requested = requested or "auto"
    if requested not in ("auto", "fused", "pallas", "xla"):
        raise ValueError(f"unknown attention backend: {requested!r}")
    if dropout:
        if requested in ("fused", "pallas"):
            raise ValueError(
                f"{requested} attention backend requires deterministic mode "
                "(attention dropout runs on the XLA path)"
            )
        return "xla"
    if requested != "auto":
        return requested
    itemsize = torch.empty((), dtype=_as_dtype(dtype)).element_size()
    if _fused.fused_auto_eligible(q_len, kv_len, dim, itemsize=itemsize, backward=backward):
        return "fused"
    if _flash.flash_eligible(dim):
        return "pallas"
    raise NotImplementedError(
        f"auto attention at q_len={q_len}, kv_len={kv_len}, head_dim={dim} is "
        f"outside the fused kernel's band{' for training' if backward else ''}, and "
        f"the flash kernels take head dims up to {_flash.MAX_DIM} (zero-padded to "
        f"multiples of {_fused.DIM_ALIGN})"
    )


def resolve_relative_backend(height: int, width: int, dim: int, *,
                             requested: Optional[str] = None) -> str:
    """The port's rule for BoTNet's 2-D relative-position attention,
    returning ``'pallas'`` (the relative-position kernels of
    :mod:`sav_tpu_torch.ops.flash_attention`) or ``'xla'`` (the dense bias
    and :func:`dense_attention`). ``auto``/None and ``pallas`` take the
    kernels at every length, on CPU (their plain versions) and on CUDA
    alike: ``sav_tpu``'s ``L ≥ 256`` threshold for them is a TPU v5e
    measurement and is not carried over. Raises for another backend, and
    where the kernels do not take the head dim or grid."""
    requested = requested or "auto"
    if requested not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention backend: {requested!r}")
    if requested == "xla":
        return "xla"
    if not _flash.rel_eligible(dim, height, width):
        raise NotImplementedError(
            f"relative-position attention at head_dim={dim} on a {height}x{width} grid is "
            "outside the relative-position kernels' band "
            "(sav_tpu_torch.ops.flash_attention.rel_eligible); backend='xla' takes it"
        )
    return "pallas"


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    backend: Optional[str] = None,
    logits_dtype=None,
    dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Backend-dispatched attention on ``[B, L, H, D]`` inputs (see the module
    docstring). ``logits_dtype`` applies to the ``xla`` path only; the
    kernel always takes its softmax in f32. ``dropout``, an active dropout
    layer or None, applies to the probabilities and forces the ``xla``
    path."""
    if query.ndim != 4:
        raise ValueError(f"attention expects [B, L, H, D] inputs, got {tuple(query.shape)}")
    backend = resolve_attention_backend(
        query.shape[1], key.shape[1], query.shape[-1],
        dtype=query.dtype, requested=backend,
        backward=_fused.requires_backward(query, key, value, bias),
        dropout=dropout is not None,
    )
    if backend == "fused":
        return _fused.fused_attention(query, key, value, bias, scale=scale)
    if backend == "pallas":
        return _flash.flash_attention(query, key, value, bias, scale=scale)
    return dense_attention(
        query, key, value, bias, scale=scale, logits_dtype=logits_dtype, dropout=dropout
    )
