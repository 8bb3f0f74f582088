"""Single-pass fused attention for sequences whose whole K/V fits on chip.

Port of :mod:`sav_tpu.ops.fused_attention`'s forward. The kernel is
``sav_tpu_torch/csrc/fused_attention.cu`` (CUDA C++ for sm_90a, built by
:mod:`sav_tpu_torch.ops._build`); it replaces the TPU kernel
``_fused_kernel`` (``sav_tpu/ops/fused_attention.py:146``). This module holds
its wrapper :func:`fused_attention`, its plain PyTorch version
:func:`fused_attention_reference`, the eligibility rule :func:`fused_eligible`
and the launch counter :data:`LAUNCHES`.

The wrapper runs the plain version on CPU tensors, and only there; on CUDA
tensors it launches the kernel or raises. There is no backward yet: the
training slice brings the ``torch.autograd.Function`` with a backward kernel,
so CUDA inputs that require grad are refused.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from sav_tpu_torch.ops import _build

# Mirrors kWarps, kRows and kMaxDim in csrc/fused_attention.cu.
_WARPS = 4
_ROWS = 4
MAX_DIM = 256
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset; the wrapper adds one per launch.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = 0


def _count_launch() -> None:
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1


def fused_smem_bytes(kv_len: int, dim: int, itemsize: int) -> int:
    """Shared memory of one kernel block: the whole K (rows padded by 16
    bytes) and V in the input dtype, plus each warp's f32 query and score
    rows. Same formula as ``smem_bytes`` in the CUDA source."""
    vec = 16 // itemsize
    per_warp_rows = _WARPS * _ROWS * (dim + -(-kv_len // 4) * 4) * 4
    return kv_len * (2 * dim + vec) * itemsize + per_warp_rows


def fused_eligible(q_len: int, kv_len: int, dim: int, *, itemsize: int = 2) -> bool:
    """True when the kernel takes the shape: a head dim that is a multiple of
    8 up to 256, and the whole kv sequence within one block's shared memory
    (replaces the TPU's 8 MiB VMEM estimate)."""
    return (
        q_len >= 1
        and kv_len >= 1
        and dim % 8 == 0
        and 0 < dim <= MAX_DIM
        and fused_smem_bytes(kv_len, dim, itemsize) <= SMEM_LIMIT
    )


def fused_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Plain PyTorch version of the kernel, same arithmetic: f32 scores
    scaled after the product, f32 bias, full-row softmax, probabilities cast
    to the value dtype before PV, division by the f32 row sum."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(value.dtype).float(), value.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(query.dtype)
    if with_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention")
    lib.sav_fused_attention_fwd.argtypes = [
        ctypes.c_int,  # dtype
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias, o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 16 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_fused_attention_fwd.restype = ctypes.c_int
    lib.sav_fused_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sav_fused_attention_smem_bytes.restype = ctypes.c_size_t
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(query, key, value, bias, scale, with_lse):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = query.dtype
    if dtype not in _DTYPE_CODES or key.dtype != dtype or value.dtype != dtype:
        raise ValueError(
            "fused attention kernel takes q/k/v all float32 or all bfloat16, "
            f"got {query.dtype}/{key.dtype}/{value.dtype}"
        )
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (query, key, value, bias)
    ):
        raise NotImplementedError(
            "fused attention on CUDA has no backward kernel yet (ROADMAP "
            "queue B2); run under torch.inference_mode() or no_grad()"
        )
    vec = 16 // query.element_size()
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.stride(-1) != 1:
            raise ValueError(f"fused attention needs unit stride on D, {name} has {t.stride()}")
    for name, t in (("key", key), ("value", value)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(
                f"fused attention reads {name} in 16-byte chunks: its pointer "
                f"and its B/L/H strides {t.stride()[:3]} must be 16-byte aligned"
            )
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
        rc = lib.sav_fused_attention_fwd(
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
    if rc != 0:
        raise RuntimeError(
            "fused attention kernel launch failed: "
            f"{lib.sav_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    _count_launch()
    return (out, lse) if with_lse else out


def fused_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Fused single-pass attention.

    Args:
      query: ``[B, q_len, heads, head_dim]``.
      key, value: ``[B, kv_len, heads, head_dim]``; the whole kv sequence
        must fit one block's shared memory (:func:`fused_eligible`).
      bias: optional additive bias broadcastable to
        ``[B, heads, q_len, kv_len]``; read through its broadcast strides.
      scale: logit scale, default ``head_dim ** -0.5``, applied to the f32
        product.
      with_lse: also return the f32 row logsumexp ``[B, heads, q_len]``.

    Returns:
      ``[B, q_len, heads, head_dim]`` in the query dtype (and the lse).
    """
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError(
            "fused attention expects [B, L, H, D] inputs, got "
            f"{tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if key.shape != value.shape or key.shape[0] != query.shape[0] or key.shape[2:] != query.shape[2:]:
        raise ValueError(
            f"mismatched q/k/v shapes {tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if bias is not None and bias.ndim != 4:
        raise ValueError(f"bias must be 4-D broadcastable, got {tuple(bias.shape)}")
    devices = {t.device for t in (query, key, value, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"fused attention inputs on several devices: {devices}")
    q_len, kv_len, dim = query.shape[1], key.shape[1], query.shape[-1]
    itemsize = query.element_size()
    if not fused_eligible(q_len, kv_len, dim, itemsize=itemsize):
        raise ValueError(
            f"kv_len={kv_len}, head_dim={dim} does not fit the fused kernel: it "
            f"needs head_dim % 8 == 0 and <= {MAX_DIM}, and "
            f"{fused_smem_bytes(kv_len, dim, itemsize)} bytes of shared memory "
            f"against {SMEM_LIMIT}; longer sequences need the flash kernel "
            "(ROADMAP queue B3)"
        )
    if scale is None:
        scale = dim ** -0.5
    device = query.device.type
    if device == "cpu":
        return fused_attention_reference(
            query, key, value, bias, scale=scale, with_lse=with_lse
        )
    if device != "cuda":
        raise ValueError(f"fused attention runs on CPU or CUDA tensors, got {device}")
    return _launch(query, key, value, bias, scale, with_lse)
