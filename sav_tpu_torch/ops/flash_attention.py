"""Blocked (flash) attention for sequences of any length.

Port of :mod:`sav_tpu.ops.flash_attention` (the no-relative-bias part).
Three kernels, CUDA C++ for sm_90a built by :mod:`sav_tpu_torch.ops._build`:

- ``csrc/flash_attention.cu``, the forward; it replaces the TPU kernel
  ``_kernel`` with its epilogue ``_online_softmax_step``
  (``sav_tpu/ops/flash_attention.py:86`` / ``:57``). Wrapper
  :func:`flash_attention`, plain version :func:`flash_attention_reference`,
  launch counter :data:`LAUNCHES`.
- ``csrc/flash_attention_bwd.cu``, two kernels: dq, which replaces
  ``_bwd_dq_kernel`` (``:360``; wrapper :func:`flash_attention_bwd_dq`,
  plain version :func:`flash_bwd_dq_reference`, counter
  :data:`BWD_DQ_LAUNCHES`), and dk/dv, which replaces ``_bwd_dkv_kernel``
  (``:405``; :func:`flash_attention_bwd_dkv`, :func:`flash_bwd_dkv_reference`,
  :data:`BWD_DKV_LAUNCHES`). ``delta = Σ_d dO·O`` is one PyTorch reduction
  before them, as ``sav_tpu`` forms it outside its kernels (``:337``).

When an input requires grad, :func:`flash_attention` runs through
:class:`FlashAttentionFunction`, the counterpart of the ``_flash``
custom_vjp: without a bias the forward keeps the f32 row logsumexp
``[B, H, Lq]`` and the backward runs the dq and dk/dv kernels; with a bias
the forward keeps no lse and the backward is the dense recompute
(:func:`sav_tpu_torch.ops.attention.dense_recompute_bwd`), which also gives
the bias gradient.

The TPU's 128-lane broadcast of lse and delta, its padding of the head dim
to 128 and its ``block_b`` are TPU layout and are not carried over.

Every wrapper runs its plain version on CPU tensors, and only there; on CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from sav_tpu_torch.ops import _build
from sav_tpu_torch.ops.fused_attention import (
    _check_dtypes,
    _check_strides,
    _DTYPE_CODES,
    _device_of,
    _raise_on_error,
    requires_backward,
)

# Mirrors kTile and kMaxDim in csrc/flash_attention.cu and
# csrc/flash_attention_bwd.cu: q rows per block and kv rows per tile, and
# the largest head dim.
BLOCK = 64
MAX_DIM = 128
# Row stride, in f32, of a tile of scores (kTile + 4 in the CUDA sources).
_SCORE_LD = BLOCK + 4

# Kernel launches since the last reset: the forward, the dq kernel and the
# dk/dv kernel; each wrapper adds one per launch of its kernel.
LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set the three launch counters to 0."""
    global LAUNCHES, BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = BWD_DQ_LAUNCHES = BWD_DKV_LAUNCHES = 0


def _count(counter: str) -> None:
    with _LAUNCH_LOCK:
        globals()[counter] += 1


def flash_smem_bytes(dim: int) -> dict:
    """Dynamic shared memory of one block of each kernel: f32 tiles of 64
    rows at a row stride of ``dim + 4`` and f32 score tiles of 64 × 68. The
    forward holds q, k, v and p; dq holds q, dO, k, v and ds; dk/dv holds k,
    v, q, dO, p, ds and the q tile's lse and delta. Same formulas as
    ``smem_bytes`` in the CUDA sources."""
    tile = BLOCK * (dim + 4) * 4
    scores = BLOCK * _SCORE_LD * 4
    return {
        "fwd": 3 * tile + scores,
        "bwd_dq": 4 * tile + scores,
        "bwd_dkv": 4 * tile + 2 * scores + 2 * BLOCK * 4,
    }


def flash_eligible(dim: int) -> bool:
    """True when the kernels take the head dim: a multiple of 8 up to
    :data:`MAX_DIM` (the tiles are f32 whatever the input dtype, so the rule
    does not depend on it; at :data:`MAX_DIM` the largest block,
    :func:`flash_smem_bytes`, is 170,496 bytes, within the 227 KB a block may
    have). Every sequence length is taken."""
    return dim % 8 == 0 and 0 < dim <= MAX_DIM


def flash_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    block_kv: int = BLOCK,
    with_lse: bool = False,
):
    """Plain PyTorch version of the forward kernel, in
    ``_online_softmax_step``'s order: per kv tile of ``block_kv`` columns,
    f32 scores scaled after the product plus the f32 bias, running max
    ``m``, ``alpha = exp(m_prev − m)``, the *unnormalised*
    ``p = exp(s − m)`` cast to the value dtype before PV,
    ``l = alpha·l + Σ p`` and ``acc = alpha·acc + p·V`` in f32; on the last
    tile ``acc / l`` cast to the query dtype and ``lse = m + log l``. The
    rounding depends on where the running max changes, so on ``block_kv``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    if bias is not None:
        bias = bias.expand(batch, heads, q_len, kv_len)
    q = query.float()
    m = torch.full((batch, heads, q_len, 1), float("-inf"), device=query.device)
    l = torch.zeros((batch, heads, q_len, 1), device=query.device)
    acc = torch.zeros((batch, heads, q_len, dim), device=query.device)
    for start in range(0, kv_len, block_kv):
        stop = min(start + block_kv, kv_len)
        s = torch.einsum("bqhd,bkhd->bhqk", q, key[:, start:stop].float()) * scale
        if bias is not None:
            s = s + bias[..., start:stop].float()
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum(
            "bhqk,bkhd->bhqd", p.to(value.dtype).float(), value[:, start:stop].float()
        )
        acc = acc * alpha + pv
        m = m_new
    out = (acc / l).permute(0, 2, 1, 3).to(query.dtype)
    if with_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def _recompute(query, key, value, grad, lse, delta, scale):
    """P from the f32 lse and ``ds = P·(dO·Vᵀ − delta)``, both f32
    ``[B, H, Lq, Lk]``, as both backward kernels form them."""
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", grad.float(), value.float())
    return p, p * (dp - delta.float()[..., None])


def flash_bwd_dq_reference(query, key, value, grad, lse, delta, *, scale):
    """Plain PyTorch version of the dq kernel (``_bwd_dq_kernel``): ds cast to
    the key dtype before ``dq = ds·K·scale``, summed in f32. ``lse`` and
    ``delta`` are f32 ``[B, H, Lq]``. Returns dq in the query dtype."""
    _, ds = _recompute(query, key, value, grad, lse, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(key.dtype).float(), key.float()) * scale
    return dq.to(query.dtype)


def flash_bwd_dkv_reference(query, key, value, grad, lse, delta, *, scale):
    """Plain PyTorch version of the dk/dv kernel (``_bwd_dkv_kernel``): P cast
    to the dO dtype before ``dv = Pᵀ·dO``, ds to the query dtype before
    ``dk = dsᵀ·Q·scale``, summed in f32. Returns ``(dk, dv)`` in the dtypes
    of k and v."""
    p, ds = _recompute(query, key, value, grad, lse, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(grad.dtype).float(), grad.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(query.dtype).float(), query.float()) * scale
    return dk.to(key.dtype), dv.to(value.dtype)


def bwd_delta(out: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """``delta = Σ_d dO·O`` in f32, ``[B, H, Lq]`` contiguous (``_bwd_prep``)."""
    return (grad.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_reference(query, key, value, out, lse, grad, *, scale=None):
    """Plain PyTorch version of the whole blocked backward: delta, then the dq
    and dk/dv kernels' arithmetic. Returns ``(dq, dk, dv)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    delta = bwd_delta(out, grad)
    dq = flash_bwd_dq_reference(query, key, value, grad, lse, delta, scale=scale)
    dk, dv = flash_bwd_dkv_reference(query, key, value, grad, lse, delta, scale=scale)
    return dq, dk, dv


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.sav_flash_attention_fwd.argtypes = [
        ctypes.c_int,  # dtype
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias, o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 16 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_flash_attention_fwd.restype = ctypes.c_int
    lib.sav_flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.sav_flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.sav_flash_attention_bwd_dq.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 6,  # q, k, v, dO, lse, delta
        ctypes.c_void_p,  # dq
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 15 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_flash_attention_bwd_dkv.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 6,  # q, k, v, dO, lse, delta
        ctypes.c_void_p, ctypes.c_void_p,  # dk, dv
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 18 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    for fn in (lib.sav_flash_attention_bwd_dq, lib.sav_flash_attention_bwd_dkv):
        fn.restype = ctypes.c_int
    for fn in (lib.sav_flash_attention_bwd_dq_smem_bytes, lib.sav_flash_attention_bwd_dkv_smem_bytes):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_dim(dim: int) -> None:
    if not flash_eligible(dim):
        raise ValueError(
            f"head_dim={dim} does not fit the flash kernels: they take a "
            f"multiple of 8 up to {MAX_DIM}"
        )


def _launch(query, key, value, bias, scale, with_lse):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = _check_dtypes(query, key, value)
    named = (("query", query), ("key", key), ("value", value))
    _check_strides(named, named)
    out = torch.empty((batch, q_len, heads, dim), dtype=dtype, device=query.device)
    lse = (
        torch.empty((batch, heads, q_len), dtype=torch.float32, device=query.device)
        if with_lse else None
    )
    bias_strides = (0, 0, 0, 0)
    if bias is not None:
        # Broadcast axes keep stride 0: a compact bias is never materialised.
        bias = bias.to(torch.float32).expand(batch, heads, q_len, kv_len)
        bias_strides = bias.stride()
    strides = (
        *query.stride()[:3], *key.stride()[:3], *value.stride()[:3],
        *out.stride()[:3], *bias_strides,
    )
    lib = _lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_flash_attention_fwd(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            batch, heads, q_len, kv_len, dim,
            (ctypes.c_int64 * 16)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "flash attention")
    _count("LAUNCHES")
    return (out, lse) if with_lse else out


def _bwd_operands(query, key, value, grad, lse, delta):
    """Checked backward operands: the incoming gradient cast to the inputs'
    dtype (and copied only if the kernels cannot read it strided), lse and
    delta contiguous f32 ``[B, H, Lq]``."""
    batch, q_len, heads, _ = query.shape
    dtype = _check_dtypes(query, key, value)
    grad = grad.to(dtype)
    vec = 16 // grad.element_size()
    if grad.stride(-1) != 1 or grad.data_ptr() % 16 or any(s % vec for s in grad.stride()[:3]):
        grad = grad.contiguous()
    named = (("query", query), ("key", key), ("value", value), ("grad", grad))
    _check_strides(named, named)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (batch, heads, q_len) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [B, H, Lq], got {t.dtype} {tuple(t.shape)}")
    return dtype, grad, lse.contiguous(), delta.contiguous()


def _launch_bwd_dq(query, key, value, grad, lse, delta, scale):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype, grad, lse, delta = _bwd_operands(query, key, value, grad, lse, delta)
    dq = torch.empty((batch, q_len, heads, dim), dtype=dtype, device=query.device)
    strides = tuple(s for t in (query, key, value, grad, dq) for s in t.stride()[:3])
    lib = _bwd_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_flash_attention_bwd_dq(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            batch, heads, q_len, kv_len, dim,
            (ctypes.c_int64 * 15)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "flash attention dq")
    _count("BWD_DQ_LAUNCHES")
    return dq


def _launch_bwd_dkv(query, key, value, grad, lse, delta, scale):
    batch, _, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype, grad, lse, delta = _bwd_operands(query, key, value, grad, lse, delta)
    dk = torch.empty((batch, kv_len, heads, dim), dtype=dtype, device=query.device)
    dv = torch.empty_like(dk)
    strides = tuple(s for t in (query, key, value, grad, dk, dv) for s in t.stride()[:3])
    lib = _bwd_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_flash_attention_bwd_dkv(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            batch, heads, query.shape[1], kv_len, dim,
            (ctypes.c_int64 * 18)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "flash attention dk/dv")
    _count("BWD_DKV_LAUNCHES")
    return dk, dv


def _forward(query, key, value, bias, scale, with_lse):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if query.device.type == "cpu":
        return flash_attention_reference(
            query, key, value, bias, scale=scale, with_lse=with_lse
        )
    return _launch(query, key, value, bias, scale, with_lse)


def flash_attention_bwd_dq(query, key, value, grad, lse, delta, *, scale):
    """dq of :func:`flash_attention` (no bias) from the forward's f32 lse and
    ``delta`` (:func:`bwd_delta`), both ``[B, H, Lq]``. The plain version on
    CPU tensors, the dq kernel on CUDA tensors."""
    _check_dim(query.shape[-1])
    if _device_of(query, key, value, grad, lse, delta) == "cpu":
        return flash_bwd_dq_reference(query, key, value, grad, lse, delta, scale=scale)
    return _launch_bwd_dq(query, key, value, grad, lse, delta, scale)


def flash_attention_bwd_dkv(query, key, value, grad, lse, delta, *, scale):
    """``(dk, dv)`` of :func:`flash_attention` (no bias); see
    :func:`flash_attention_bwd_dq`. The dk/dv kernel on CUDA tensors."""
    _check_dim(query.shape[-1])
    if _device_of(query, key, value, grad, lse, delta) == "cpu":
        return flash_bwd_dkv_reference(query, key, value, grad, lse, delta, scale=scale)
    return _launch_bwd_dkv(query, key, value, grad, lse, delta, scale)


def flash_attention_bwd(query, key, value, out, lse, grad, *, scale=None):
    """Gradients of :func:`flash_attention` (no bias) from its saved output
    and f32 lse: delta, then the dq and the dk/dv kernels (their plain
    versions on CPU tensors). Returns ``(dq, dk, dv)`` in ``[B, L, H, D]``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    delta = bwd_delta(out, grad)
    dq = flash_attention_bwd_dq(query, key, value, grad, lse, delta, scale=scale)
    dk, dv = flash_attention_bwd_dkv(query, key, value, grad, lse, delta, scale=scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a backward (``sav_tpu``'s ``_flash`` custom_vjp):
    without a bias the forward keeps the f32 lse and the backward runs the
    dq and dk/dv kernels; with a bias the forward keeps no lse and the
    backward is the dense recompute, which also gives the bias gradient
    (un-broadcast to the bias's shape)."""

    @staticmethod
    def forward(ctx, query, key, value, bias, scale):
        ctx.scale = scale
        if bias is None:
            out, lse = _forward(query, key, value, None, scale, True)
            ctx.save_for_backward(query, key, value, out, lse)
        else:
            out = _forward(query, key, value, bias, scale, False)
            ctx.save_for_backward(query, key, value, bias)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.has_bias:
            query, key, value, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(query, key, value, out, lse, grad, scale=ctx.scale)
            return dq, dk, dv, None, None
        from sav_tpu_torch.ops.attention import dense_recompute_bwd

        query, key, value, bias = ctx.saved_tensors
        dq, dk, dv, dbias = dense_recompute_bwd(query, key, value, bias, grad, ctx.scale)
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None, None


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Blocked online-softmax attention.

    Args:
      query: ``[B, q_len, heads, head_dim]``.
      key, value: ``[B, kv_len, heads, head_dim]``, any kv_len; head_dim a
        multiple of 8 up to :data:`MAX_DIM` (:func:`flash_eligible`).
      bias: optional additive bias broadcastable to
        ``[B, heads, q_len, kv_len]``; read through its broadcast strides.
      scale: logit scale, default ``head_dim ** -0.5``, applied to the f32
        product.
      with_lse: also return the f32 row logsumexp ``[B, heads, q_len]``
        (forward only: not with inputs that require grad).

    Returns:
      ``[B, q_len, heads, head_dim]`` in the query dtype (and the lse).
    """
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError(
            "flash attention expects [B, L, H, D] inputs, got "
            f"{tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if key.shape != value.shape or key.shape[0] != query.shape[0] or key.shape[2:] != query.shape[2:]:
        raise ValueError(
            f"mismatched q/k/v shapes {tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if bias is not None and bias.ndim != 4:
        raise ValueError(f"bias must be 4-D broadcastable, got {tuple(bias.shape)}")
    _device_of(query, key, value, bias)
    dim = query.shape[-1]
    _check_dim(dim)
    if scale is None:
        scale = dim ** -0.5
    if not requires_backward(query, key, value, bias):
        return _forward(query, key, value, bias, scale, with_lse)
    if with_lse:
        raise ValueError("with_lse=True is forward-only; the lse of a differentiated call stays internal")
    return FlashAttentionFunction.apply(query, key, value, bias, float(scale))
