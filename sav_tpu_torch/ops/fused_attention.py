"""Single-pass fused attention for sequences whose whole K/V fits on chip.

Port of :mod:`sav_tpu.ops.fused_attention`. Two kernels, CUDA C++ for
sm_90a built by :mod:`sav_tpu_torch.ops._build`:

- ``csrc/fused_attention.cu``, the forward; it replaces the TPU kernel
  ``_fused_kernel`` (``sav_tpu/ops/fused_attention.py:146``). Wrapper
  :func:`fused_attention`, plain version :func:`fused_attention_reference`,
  launch counter :data:`LAUNCHES`. Two variants (:func:`fused_fwd_variant`):
  bf16 at head dims up to 128 on the tensor cores, f32 (and bf16 above
  128) on the CUDA cores in exact f32; :data:`FWD_VARIANT_LAUNCHES` tallies
  each launch under its variant too.
- ``csrc/fused_attention_bwd.cu``, the backward; it replaces
  ``_fused_bwd_kernel`` (``sav_tpu/ops/fused_attention.py:351``) and forms
  ``delta = Σ_d dO·O`` itself. Wrapper :func:`fused_attention_bwd`, plain
  version :func:`fused_attention_bwd_reference`, launch counter
  :data:`BWD_LAUNCHES`. Two variants (:func:`fused_bwd_variant`): bf16 at
  head dims up to 128 on the tensor cores, f32 (and bf16 above 128) on the
  CUDA cores in exact f32; :data:`BWD_VARIANT_LAUNCHES` tallies each launch
  under its variant too.

When an input requires grad, :func:`fused_attention` runs through
:class:`FusedAttentionFunction`, the counterpart of ``sav_tpu``'s
``custom_vjp``: without a bias the forward keeps the f32 row logsumexp and
the backward is the kernel; with a bias the forward keeps no lse and the
backward is the dense recompute
(:func:`sav_tpu_torch.ops.attention.dense_recompute_bwd`), which also gives
the bias gradient.

Head dims: the kernels are built for multiples of 8. :func:`fused_attention`
and :func:`fused_attention_bwd` take any other head dim up to the largest
(TNT's inner heads: 6 and 10) by zero-padding q, k, v (and O, dO) to the
next multiple of 8 (:func:`pad_head_dim`) with the scale of the true head
dim, and slicing the outputs back: the padded columns add 0 to every Q·Kᵀ
and give 0 in every output column past the true one, so the result is the
unpadded attention. The pad comes before the CPU/CUDA split, so the plain
versions see the padded tensors too; through autograd the gradients come
back sliced. ``sav_tpu``'s own wrapper pads the head dim to 128 lanes
(``sav_tpu/ops/fused_attention.py:221-231``).

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

# Mirrors kWarps, kRows and kMaxDim in csrc/fused_attention.cu, and kWarps
# in csrc/fused_attention_bwd.cu.
_WARPS = 4
_ROWS = 4
_BWD_WARPS = 8
MAX_DIM = 256
# The variants of both kernels, as ``sav_fused_attention_variant`` and
# ``sav_fused_attention_bwd_variant`` pick them: bf16 up to head dim
# MMA_MAX_DIM on the tensor cores (mma.sync), the rest on the CUDA cores.
# Mirrors kMmaMaxDim in both sources, kMmaWarps in csrc/fused_attention.cu
# and kMq (q rows per tile) in csrc/fused_attention_bwd.cu.
TENSOR_CORE = "tensor_core"
CUDA_CORE = "cuda_core"
MMA_MAX_DIM = 128
_MMA_FWD_WARPS = 4
_MMA_Q_ROWS = 32
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
# The kernels take head dims that are multiples of this; the wrappers pad
# any other head dim up to one (pad_head_dim).
DIM_ALIGN = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset, forward and backward; each wrapper
# adds one per launch of its kernel.
LAUNCHES = 0
BWD_LAUNCHES = 0
# The launches of each kernel by variant (each also counts in LAUNCHES or
# BWD_LAUNCHES).
FWD_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set both launch counters (and the tallies by variant) to 0."""
    global LAUNCHES, BWD_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = 0
        BWD_LAUNCHES = 0
        for tally in (FWD_VARIANT_LAUNCHES, BWD_VARIANT_LAUNCHES):
            tally.update(dict.fromkeys(tally, 0))


def _count_launch(variant: str) -> None:
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        FWD_VARIANT_LAUNCHES[variant] += 1


def _count_bwd_launch(variant: str) -> None:
    global BWD_LAUNCHES
    with _LAUNCH_LOCK:
        BWD_LAUNCHES += 1
        BWD_VARIANT_LAUNCHES[variant] += 1


def padded_dim(dim: int) -> int:
    """The head dim the kernels run at: ``dim`` rounded up to a multiple of
    :data:`DIM_ALIGN`."""
    return -(-dim // DIM_ALIGN) * DIM_ALIGN


def pad_head_dim(*tensors: torch.Tensor) -> tuple:
    """Each ``[..., D]`` tensor with zero columns up to :func:`padded_dim`
    (``F.pad``: autograd slices its gradient back to D); tensors whose D is
    a multiple of :data:`DIM_ALIGN` pass as they are."""
    return tuple(
        t if t.shape[-1] % DIM_ALIGN == 0
        else torch.nn.functional.pad(t, (0, padded_dim(t.shape[-1]) - t.shape[-1]))
        for t in tensors
    )


def fused_fwd_variant(dim: int, itemsize: int) -> str:
    """The forward's variant: bf16 (``itemsize`` 2) at head dims up to
    :data:`MMA_MAX_DIM` on the tensor cores, f32 (4), and bf16 above, on the
    CUDA cores (exact f32 products, no TF32). Same rule as
    ``sav_fused_attention_variant``."""
    if itemsize not in (2, 4):
        raise ValueError(f"the fused kernels take float32 or bfloat16, got itemsize {itemsize}")
    return TENSOR_CORE if itemsize == 2 and dim <= MMA_MAX_DIM else CUDA_CORE


def fused_fwd_mma_rows(dim: int) -> int:
    """Query rows of one tensor-core forward block: 4 warps of 32 rows up to
    head dim 64, of 16 above (``mma_rows``)."""
    return 16 * _MMA_FWD_WARPS * (2 if -(-dim // 16) * 16 <= 64 else 1)


def fused_smem_bytes(kv_len: int, dim: int, itemsize: int) -> int:
    """Shared memory of one forward block of the variant that takes the
    shape. Tensor cores: the slice's K and V in bf16, ``round_up(kv_len,
    16)`` rows of ``round_up(dim, 16) + 8`` each, V's space holding at
    least the block's q rows (the q tile lands there first). CUDA cores:
    the whole K (rows padded by 16 bytes) and V in the input dtype, plus
    each warp's f32 query and score rows. Same formulas as
    ``mma_smem_bytes`` and ``smem_bytes`` in the CUDA source."""
    if itemsize == 2 and fused_fwd_variant(dim, itemsize) == TENSOR_CORE:
        rows = -(-kv_len // 16) * 16
        return (rows + max(rows, fused_fwd_mma_rows(dim))) * (-(-dim // 16) * 16 + 8) * 2
    return _cuda_core_smem_bytes(kv_len, dim, itemsize)


def _cuda_core_smem_bytes(kv_len: int, dim: int, itemsize: int) -> int:
    vec = 16 // itemsize
    per_warp_rows = _WARPS * _ROWS * (dim + -(-kv_len // 4) * 4) * 4
    return kv_len * (2 * dim + vec) * itemsize + per_warp_rows


def fused_bwd_variant(dim: int, itemsize: int) -> str:
    """The backward's variant: bf16 (``itemsize`` 2) at head dims up to
    :data:`MMA_MAX_DIM` on the tensor cores, everything else on the CUDA
    cores (exact f32 products, no TF32). Same rule as
    ``sav_fused_attention_bwd_variant``."""
    return TENSOR_CORE if itemsize == 2 and dim <= MMA_MAX_DIM else CUDA_CORE


def fused_bwd_mma_warps(dim: int) -> int:
    """Warps of a tensor-core backward block, 16 kv rows each: 16 up to
    head dim 64, 8 above (``mma_warps``)."""
    return 16 if -(-dim // 16) * 16 <= 64 else 8


def fused_bwd_mma_rounds(kv_len: int, dim: int) -> int:
    """Rounds of kv rows a tensor-core backward block sweeps the q tiles
    for (``mma_rounds``); above one, dq's f32 partial sums need a scratch
    of ``B·H·Lq·D`` floats."""
    rows = 16 * fused_bwd_mma_warps(dim)
    return -(-(-(-kv_len // 16) * 16) // rows)


def fused_bwd_mma_smem_bytes(q_len: int, kv_len: int, dim: int) -> int:
    """Shared memory of one tensor-core backward block: the slice's K and V
    in bf16 (rows padded to 16, each ``round_up(dim, 16) + 8`` long), two
    stages of 32-row q and dO tiles, a round's dSᵀ tile (16 kv rows per
    warp × 40) and the f32 lse and delta of every q row (rounded up to 32).
    Same formula as ``mma_smem_bytes`` in ``csrc/fused_attention_bwd.cu``."""
    ld = -(-dim // 16) * 16 + 8
    return (
        2 * (-(-kv_len // 16) * 16) * ld * 2
        + 4 * _MMA_Q_ROWS * ld * 2
        + 16 * fused_bwd_mma_warps(dim) * (_MMA_Q_ROWS + 8) * 2
        + 2 * (-(-q_len // _MMA_Q_ROWS) * _MMA_Q_ROWS) * 4
    )


def fused_bwd_smem_bytes(kv_len: int, dim: int, itemsize: int, rows: int) -> int:
    """Shared memory of one CUDA-core backward block at ``rows`` query rows
    per warp: K and V (rows padded by 16 bytes), f32 dK and dV, and for a
    tile of ``8 * rows`` query rows its f32 q, dO, p and ds rows. Same
    formula as ``smem_bytes`` in ``csrc/fused_attention_bwd.cu``."""
    vec = 16 // itemsize
    tile = _BWD_WARPS * rows
    return (
        2 * kv_len * (dim + vec) * itemsize
        + 2 * kv_len * dim * 4
        + 2 * tile * dim * 4
        + 2 * tile * (-(-kv_len // 4) * 4) * 4
    )


def fused_bwd_rows(kv_len: int, dim: int, itemsize: int) -> int:
    """Query rows per warp the CUDA-core backward launcher picks: the
    largest of 4, 2 and 1 that fits shared memory, 0 when none does
    (``pick_rows``)."""
    for rows in (4, 2, 1):
        if fused_bwd_smem_bytes(kv_len, dim, itemsize, rows) <= SMEM_LIMIT:
            return rows
    return 0


def _bwd_bytes(q_len: int, kv_len: int, dim: int, itemsize: int) -> int:
    """Shared memory of the smallest backward block of the variant that
    takes the shape (one row per warp for the CUDA-core variant)."""
    if fused_bwd_variant(dim, itemsize) == TENSOR_CORE:
        return fused_bwd_mma_smem_bytes(q_len, kv_len, dim)
    return fused_bwd_smem_bytes(kv_len, dim, itemsize, 1)


def fused_eligible(
    q_len: int, kv_len: int, dim: int, *, itemsize: int = 2, backward: bool = False
) -> bool:
    """True when the kernel takes the shape: a head dim up to 256, padded
    to a multiple of 8 (:func:`padded_dim`; the budgets below are the
    padded dim's), and the whole kv sequence within one block's shared
    memory of the forward's variant (replaces the TPU's 8 MiB VMEM
    estimate; in bf16 the tensor-core forward takes kv_len up to 800 at
    head dim 64, and every shape the CUDA-core forward's band takes).
    ``backward=True`` also counts the backward kernel's bytes for its
    variant: the tensor-core variant keeps bf16 K/V (kv_len up to 640 at
    head dim 64), the CUDA-core one f32 dK/dV too (kv_len up to 203 at head
    dim 64 in f32)."""
    dim = padded_dim(dim)
    return (
        q_len >= 1
        and kv_len >= 1
        and 0 < dim <= MAX_DIM
        and fused_smem_bytes(kv_len, dim, itemsize) <= SMEM_LIMIT
        and (not backward or _bwd_bytes(q_len, kv_len, dim, itemsize) <= SMEM_LIMIT)
    )


def fused_auto_eligible(
    q_len: int, kv_len: int, dim: int, *, itemsize: int = 2, backward: bool = False
) -> bool:
    """``auto``'s rule for the fused kernels: :func:`fused_eligible` within
    the bands of the CUDA-core kernels whatever the variant: the forward's
    (kv_len up to 679 at head dim 64 in bf16) and, for a backward, the
    backward's (up to 264), each at the padded head dim. The tensor-core
    variants take wider bands (kv_len up to 800 forward, 640 backward), and
    every shape inside the narrow bands is inside the wide ones, but
    ``auto``'s crossover to the flash kernels stays where it was. The
    backward's is to move only after the flash backward kernels (#4, #5)
    are redesigned: at 264 it keeps ViT-B/16@384 training (kv 577) on
    #3-#5, the only main path that runs them, and a crossover set now would
    hold #2 against #4/#5 before their redesign. The forward's is measured
    (#1 against #3) but not moved."""
    padded = padded_dim(dim)
    return (
        fused_eligible(q_len, kv_len, dim, itemsize=itemsize, backward=backward)
        and _cuda_core_smem_bytes(kv_len, padded, itemsize) <= SMEM_LIMIT
        and (not backward or fused_bwd_rows(kv_len, padded, itemsize) > 0)
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


def fused_attention_bwd_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad: torch.Tensor,
    *,
    scale: Optional[float] = None,
):
    """Plain PyTorch version of the backward kernel, same arithmetic
    (``_fused_bwd_kernel``): P recomputed from the f32 lse ``[B, H, Lq]``,
    ``delta = Σ_d dO·O`` in f32, ``ds = P·(dO·Vᵀ − delta)``; ds is cast to
    the key/query dtype before ``dq = ds·K·scale`` and ``dk = dsᵀ·Q·scale``,
    P to the dO dtype before ``dv = Pᵀ·dO``, every product summed in f32.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", grad.float(), value.float())
    delta = (grad.float() * out.float()).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(key.dtype).float(), key.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(grad.dtype).float(), grad.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(query.dtype).float(), query.float()) * scale
    return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype)


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
    lib.sav_fused_attention_variant.argtypes = [ctypes.c_int] * 2
    lib.sav_fused_attention_variant.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_attention_bwd")
    lib.sav_fused_attention_bwd.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 6,  # q, k, v, o, dO, lse
        *[ctypes.c_void_p] * 3,  # dq, dk, dv
        ctypes.c_void_p,  # dq_acc (f32 scratch, may be null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 24 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_fused_attention_bwd.restype = ctypes.c_int
    lib.sav_fused_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sav_fused_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.sav_fused_attention_bwd_rows.argtypes = [ctypes.c_int] * 3
    lib.sav_fused_attention_bwd_rows.restype = ctypes.c_int
    lib.sav_fused_attention_bwd_variant.argtypes = [ctypes.c_int] * 2
    lib.sav_fused_attention_bwd_variant.restype = ctypes.c_int
    lib.sav_fused_attention_bwd_mma_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sav_fused_attention_bwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.sav_fused_attention_bwd_mma_rounds.argtypes = [ctypes.c_int] * 2
    lib.sav_fused_attention_bwd_mma_rounds.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_dtypes(*tensors) -> torch.dtype:
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            "the attention kernels take q/k/v all float32 or all bfloat16, "
            f"got {'/'.join(str(t.dtype) for t in tensors)}"
        )
    return dtype


def _chunk_aligned(t: torch.Tensor) -> bool:
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])


def _check_strides(named_rows, named_chunked) -> None:
    """Unit stride on D for every operand; 16-byte aligned pointers and B/L/H
    strides for the operands the kernel reads in 16-byte chunks."""
    for name, t in named_rows:
        if t.stride(-1) != 1:
            raise ValueError(f"the attention kernels need unit stride on D, {name} has {t.stride()}")
    for name, t in named_chunked:
        if not _chunk_aligned(t):
            raise ValueError(
                f"the attention kernels read {name} in 16-byte chunks: its pointer "
                f"and its B/L/H strides {t.stride()[:3]} must be 16-byte aligned"
            )


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.sav_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def _launch(query, key, value, bias, scale, with_lse):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = _check_dtypes(query, key, value)
    variant = fused_fwd_variant(dim, query.element_size())
    # The tensor-core variant also copies q in 16-byte chunks.
    chunked = (("key", key), ("value", value))
    if variant == TENSOR_CORE:
        chunked = (("query", query),) + chunked
    _check_strides((("query", query), ("key", key), ("value", value)), chunked)
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
    _raise_on_error(lib, rc, "fused attention")
    _count_launch(variant)
    return (out, lse) if with_lse else out


def _launch_bwd(query, key, value, out, lse, grad, scale):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = _check_dtypes(query, key, value, out)
    # The incoming gradient may arrive in another layout or dtype; the
    # kernel reads it strided but needs unit stride on D, so only then is
    # it copied.
    variant = fused_bwd_variant(dim, query.element_size())
    tensor_core = variant == TENSOR_CORE
    grad = grad.to(dtype)
    # The tensor-core variant also copies q and dO in 16-byte chunks (and
    # reads O in aligned pairs).
    if grad.stride(-1) != 1 or (tensor_core and not _chunk_aligned(grad)):
        grad = grad.contiguous()
    chunked = (("key", key), ("value", value))
    if tensor_core:
        chunked += (("query", query), ("grad", grad), ("out", out))
    _check_strides(
        (("query", query), ("key", key), ("value", value), ("out", out), ("grad", grad)),
        chunked,
    )
    if lse.shape != (batch, heads, q_len) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [B, H, Lq], got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    dq = torch.empty((batch, q_len, heads, dim), dtype=dtype, device=query.device)
    dk = torch.empty((batch, kv_len, heads, dim), dtype=dtype, device=query.device)
    dv = torch.empty_like(dk)
    dq_acc = None
    if tensor_core and fused_bwd_mma_rounds(kv_len, dim) > 1:
        dq_acc = torch.empty(batch * heads * q_len * dim, dtype=torch.float32,
                             device=query.device)
    strides = tuple(
        s for t in (query, key, value, out, grad, dq, dk, dv) for s in t.stride()[:3]
    )
    lib = _bwd_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_fused_attention_bwd(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            out.data_ptr(), grad.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(),
            batch, heads, q_len, kv_len, dim,
            (ctypes.c_int64 * 24)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "fused attention backward")
    _count_bwd_launch(variant)
    return dq, dk, dv


def requires_backward(*tensors) -> bool:
    """True when autograd will differentiate through a call on ``tensors``
    (grad mode on and some input requires grad)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _check_bwd_band(q_len: int, kv_len: int, dim: int, itemsize: int) -> None:
    if not fused_eligible(q_len, kv_len, dim, itemsize=itemsize, backward=True):
        raise ValueError(
            f"kv_len={kv_len}, head_dim={dim} does not fit the fused backward "
            f"kernel's {fused_bwd_variant(dim, itemsize)} variant: the slice's K/V "
            f"stay in shared memory, and one block would need {_bwd_bytes(q_len, kv_len, dim, itemsize)} "
            f"bytes against {SMEM_LIMIT}; longer sequences train through the flash "
            "kernels (sav_tpu_torch.ops.flash_attention, backend='pallas')"
        )


def _device_of(*tensors) -> str:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"attention inputs on several devices: {devices}")
    device = devices.pop().type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"the attention kernels run on CPU or CUDA tensors, got {device}")
    return device


def _forward(query, key, value, bias, scale, with_lse):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if query.device.type == "cpu":
        return fused_attention_reference(
            query, key, value, bias, scale=scale, with_lse=with_lse
        )
    return _launch(query, key, value, bias, scale, with_lse)


def fused_attention_bwd(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad: torch.Tensor,
    *,
    scale: Optional[float] = None,
):
    """Gradients of :func:`fused_attention` (no bias) from its saved output
    and f32 row logsumexp ``[B, H, Lq]``: returns ``(dq, dk, dv)``, each in
    ``[B, L, H, D]`` and the dtype of its input. The plain version on CPU
    tensors, the backward kernel on CUDA tensors; a head dim off the
    multiple of 8 is zero-padded first (:func:`pad_head_dim`)."""
    dim = query.shape[-1]
    if scale is None:
        scale = dim ** -0.5
    _check_bwd_band(query.shape[1], key.shape[1], dim, query.element_size())
    if dim % DIM_ALIGN:
        grads = fused_attention_bwd(*pad_head_dim(query, key, value, out), lse,
                                    *pad_head_dim(grad), scale=scale)
        return tuple(g[..., :dim] for g in grads)
    if _device_of(query, key, value, out, lse, grad) == "cpu":
        return fused_attention_bwd_reference(
            query, key, value, out, lse, grad, scale=scale
        )
    return _launch_bwd(query, key, value, out, lse, grad, scale)


class FusedAttentionFunction(torch.autograd.Function):
    """Fused attention with a backward (``sav_tpu``'s ``_fused`` custom_vjp):
    without a bias the forward keeps the f32 lse and the backward runs
    :func:`fused_attention_bwd`; with a bias the forward keeps no lse and
    the backward is the dense recompute, which also gives the bias
    gradient (un-broadcast to the bias's shape)."""

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
            dq, dk, dv = fused_attention_bwd(
                query, key, value, out, lse, grad, scale=ctx.scale
            )
            return dq, dk, dv, None, None
        from sav_tpu_torch.ops.attention import dense_recompute_bwd

        query, key, value, bias = ctx.saved_tensors
        dq, dk, dv, dbias = dense_recompute_bwd(query, key, value, bias, grad, ctx.scale)
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None, None


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
        must fit one block's shared memory (:func:`fused_eligible`, with
        ``backward=True`` when an input requires grad). A head dim off the
        multiple of 8 runs zero-padded (:func:`pad_head_dim`).
      bias: optional additive bias broadcastable to
        ``[B, heads, q_len, kv_len]``; read through its broadcast strides.
      scale: logit scale, default ``head_dim ** -0.5`` (the true head
        dim's), applied to the f32 product.
      with_lse: also return the f32 row logsumexp ``[B, heads, q_len]``
        (forward only: not with inputs that require grad).

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
    _device_of(query, key, value, bias)
    q_len, kv_len, dim = query.shape[1], key.shape[1], query.shape[-1]
    itemsize = query.element_size()
    if not fused_eligible(q_len, kv_len, dim, itemsize=itemsize):
        raise ValueError(
            f"kv_len={kv_len}, head_dim={dim} does not fit the fused kernel: it "
            f"needs head_dim <= {MAX_DIM} (zero-padded to a multiple of {DIM_ALIGN}), and "
            f"{fused_smem_bytes(kv_len, padded_dim(dim), itemsize)} bytes of shared memory "
            f"against {SMEM_LIMIT}; longer sequences run through the flash "
            "kernels (sav_tpu_torch.ops.flash_attention, backend='pallas')"
        )
    if scale is None:
        scale = dim ** -0.5
    if dim % DIM_ALIGN:
        got = fused_attention(*pad_head_dim(query, key, value), bias, scale=scale,
                              with_lse=with_lse)
        return (got[0][..., :dim], got[1]) if with_lse else got[..., :dim]
    if not requires_backward(query, key, value, bias):
        return _forward(query, key, value, bias, scale, with_lse)
    if with_lse:
        raise ValueError("with_lse=True is forward-only; the lse of a differentiated call stays internal")
    if bias is None:
        _check_bwd_band(q_len, kv_len, dim, itemsize)
    return FusedAttentionFunction.apply(query, key, value, bias, float(scale))
