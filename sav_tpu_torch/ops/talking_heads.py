"""Fused talking-heads attention (CaiT trunk).

Port of :mod:`sav_tpu.ops.talking_heads`. Talking-heads attention mixes the
logits across heads before the softmax and the probabilities after it::

    s'_i = Σ_h W_pre[h, i] · s_h      p_i = softmax(s'_i)
    p'_i = Σ_h W_post[h, i] · p_h     out_i = p'_i · V_i

Two kernels, CUDA C++ for sm_90a built by :mod:`sav_tpu_torch.ops._build`:

- ``csrc/talking_heads.cu``, the forward; it replaces ``_th_kernel``
  (``sav_tpu/ops/talking_heads.py:67``). Wrapper
  :func:`flash_talking_heads_attention`, plain version
  :func:`talking_heads_reference`, launch counter :data:`LAUNCHES`.
- ``csrc/talking_heads_bwd.cu``, the backward; it replaces ``_th_bwd_kernel``
  (``sav_tpu/ops/talking_heads.py:183``). Wrapper :func:`talking_heads_bwd`,
  plain version :func:`talking_heads_bwd_reference` (of its two
  tensor-core kernels :func:`talking_heads_bwd_dq_reference` and
  :func:`talking_heads_bwd_dkv_reference`), launch counters
  :data:`BWD_LAUNCHES` and :data:`BWD_DKV_LAUNCHES`.

Two variants of each, by one rule for both directions (:func:`th_variant`):
bf16 at the head counts :data:`MMA_HEADS` and head dims up to :data:`MMA_MAX_DIM`
runs on the tensor cores (the forward in one kernel; the backward in two, a
dq kernel, which also leaves each row's lse and delta and the dW partials,
then a dk/dv kernel); f32, and bf16 outside that band, on the CUDA cores in
f32 (the backward in one kernel). :data:`VARIANT_LAUNCHES`,
:data:`BWD_VARIANT_LAUNCHES` and :data:`BWD_DKV_VARIANT_LAUNCHES` tally each
launch under its variant too. Which shapes the kernels take at all
(:func:`fused_eligible`, :func:`fused_bwd_eligible`) is the CUDA-core
variants' rule.

When an input requires grad the call runs through
:class:`TalkingHeadsFunction`, the counterpart of ``_th``'s ``custom_vjp``:
it saves q, k, v and both weights, and its backward is the kernel, or,
outside the backward's band, :func:`dense_talking_heads` differentiated by
autograd (``_th_bwd``'s dense recompute).

The mixing weights enter the kernels in f32 whatever the activations' dtype,
as ``TalkingHeadsBlock(None)`` hands ``sav_tpu``'s kernel its f32 parameter.

The port's dispatch rule (:func:`resolve_talking_heads_backend`): ``auto``,
``fused`` and ``pallas`` take the kernels wherever they are eligible, on CPU
(their plain versions) and on CUDA, for serving and training alike; ``xla``
takes :func:`dense_talking_heads`. ``sav_tpu`` rides its kernel under
``auto`` only when training, from a TPU v5e measurement
(``tools/th_micro.py``); that rule records the TPU and is not carried over.
``chip_smoke.py`` times the kernels against the dense path on the H100: in
bf16 both are faster across the tensor-core band, so ``auto`` keeps them.

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
    CUDA_CORE,
    SMEM_LIMIT,
    TENSOR_CORE,
    _check_dtypes,
    _check_strides,
    _chunk_aligned,
    _device_of,
    _raise_on_error,
    requires_backward,
)

# Mirrors kWarps, kMaxDim and the head counts built (SAV_TH_HEADS in
# csrc/talking_heads.cu, SAV_TH_BWD_HEADS in csrc/talking_heads_bwd.cu):
# CaiT-XXS/XS/S/M, the CPU tests' small CaiT (2) and 3; the backward not 16.
_WARPS = 8
MAX_DIM = 128
HEADS = (2, 3, 4, 6, 8, 16)
BWD_HEADS = (2, 3, 4, 6, 8)

# The tensor-core (bf16) variants' band and layout, mirrored from
# csrc/mma_tiles.cuh: the head counts built (SAV_TH_MMA_HEADS), the largest
# head dim (kThMmaMaxDim), the register budgets that set the heads a warp
# accumulates (th_heads_per_warp), the tile rows (th_kv_tile) and an SM's
# shared memory with what the runtime keeps per block (kSmemPerSM,
# kSmemPerBlockReserved).
MMA_HEADS = (2, 3, 4, 6, 8)
MMA_MAX_DIM = 48
MMA_KINDS = ("fwd", "bwd_dq", "bwd_dkv")
_MMA_LIVE_BUDGET = {"fwd": 224, "bwd_dq": 240, "bwd_dkv": 200}
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: the forward, the backward's
# CUDA-core kernel or tensor-core dq kernel (one per backward), and the
# tensor-core dk/dv kernel that follows the dq kernel; each wrapper adds one
# per launch of its kernel, and tallies it under its variant too.
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_DKV_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
_VARIANT_TALLIES = {"LAUNCHES": VARIANT_LAUNCHES, "BWD_LAUNCHES": BWD_VARIANT_LAUNCHES,
                    "BWD_DKV_LAUNCHES": BWD_DKV_VARIANT_LAUNCHES}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set the three launch counters and their tallies by variant to 0."""
    global LAUNCHES, BWD_LAUNCHES, BWD_DKV_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = BWD_LAUNCHES = BWD_DKV_LAUNCHES = 0
        for tally in _VARIANT_TALLIES.values():
            tally.update(dict.fromkeys(tally, 0))


def _count(counter: str, variant: str) -> None:
    with _LAUNCH_LOCK:
        globals()[counter] += 1
        _VARIANT_TALLIES[counter][variant] += 1


def th_variant(heads: int, dim: int, itemsize: int) -> str:
    """The variant of the forward and of the backward alike: bf16
    (``itemsize`` 2) at a head count of :data:`MMA_HEADS` and a head dim up
    to :data:`MMA_MAX_DIM` on the tensor cores (the backward's dq and dk/dv
    kernels), everything else (f32, and bf16 outside that band) on the CUDA
    cores. Same rule as ``sav_talking_heads_variant``."""
    if itemsize not in (2, 4):
        raise ValueError(f"the talking-heads kernels take float32 or bfloat16, got itemsize {itemsize}")
    in_band = itemsize == 2 and heads in MMA_HEADS and dim <= MMA_MAX_DIM
    return TENSOR_CORE if in_band else CUDA_CORE


def _mma_live_floats(kind: str, heads: int, ho: int, dk: int) -> int:
    scores = (4 if heads > 4 and kind != "fwd" else 8) * heads
    if kind == "fwd":
        return scores + 4 * heads + ho * (dk // 2 + 8)
    if kind == "bwd_dq":
        return 2 * scores + 4 * heads + ho * (dk // 2 + 8 + 2 * heads)
    return 2 * scores + ho * (dk + 16)


def th_mma_heads_per_warp(kind: str, heads: int, dim: int) -> int:
    """Heads whose products one warp of the tensor-core ``kind`` kernel
    accumulates: the largest divisor of ``heads`` for which the f32 values a
    thread holds (every head's scores, and dP' in the backward; the row
    statistics; the warp's accumulators) stay within the kernel's register
    budget, as ``th_heads_per_warp`` in ``csrc/mma_tiles.cuh`` picks it."""
    dk = -(-dim // 16) * 16
    ho = heads
    while ho > 1 and (heads % ho or _mma_live_floats(kind, heads, ho, dk) > _MMA_LIVE_BUDGET[kind]):
        ho -= 1
    return ho


def th_mma_block(kind: str, heads: int, dim: int) -> dict:
    """The tensor-core ``kind`` kernel's block: ``warps``, the ``rows`` it
    owns (q rows; kv rows for dk/dv) and the rows of each tile it streams
    (``tile``)."""
    groups = heads // th_mma_heads_per_warp(kind, heads, dim)
    row_groups = 4 // groups if 4 % groups == 0 else 1
    return {"warps": row_groups * groups, "rows": 16 * row_groups,
            "tile": 32 if heads <= 4 else 16}


def th_mma_smem_bytes(kind: str, heads: int, dim: int) -> int:
    """Shared memory of one tensor-core ``kind`` block: bf16 rows of
    ``round_up(dim, 16) + 8`` of every head (the forward's q rows and two
    stages of K and V tiles; dq's q and dO rows and two stages of K and V
    tiles; dk/dv's k and v rows and two stages of q and dO tiles with their
    f32 lse and delta rows) and the two f32 weights. Same formula as
    ``th_mma_smem_bytes`` in ``csrc/mma_tiles.cuh``."""
    block = th_mma_block(kind, heads, dim)
    rows, tile = block["rows"], block["tile"]
    ld = -(-dim // 16) * 16 + 8
    tiles = heads * (rows + 4 * tile) if kind == "fwd" else heads * (2 * rows + 4 * tile)
    extra = 2 * 2 * heads * tile * 4 if kind == "bwd_dkv" else 0
    return tiles * ld * 2 + 2 * heads * heads * 4 + extra


def th_mma_blocks_per_sm(kind: str, heads: int, dim: int) -> int:
    """Blocks of the tensor-core ``kind`` kernel that an SM's shared memory
    holds at once."""
    return SMEM_PER_SM // (th_mma_smem_bytes(kind, heads, dim) + SMEM_PER_BLOCK_RESERVED)


def _round_up4(x: int) -> int:
    return -(-x // 4) * 4


def th_smem_bytes(kv_len: int, heads: int, dim: int, itemsize: int, rows: int) -> int:
    """Shared memory of one forward block at ``rows`` query rows per warp:
    the tile's f32 scores of every head, its f32 query rows of one head, both
    weights, and one head's K or V (rows padded by 16 bytes). Same formula
    as ``smem_bytes`` in ``csrc/talking_heads.cu``."""
    tile = _WARPS * rows
    floats = tile * heads * _round_up4(kv_len) + tile * dim + 2 * _round_up4(heads * heads)
    return floats * 4 + kv_len * (dim + 16 // itemsize) * itemsize


def th_bwd_smem_bytes(kv_len: int, heads: int, dim: int, itemsize: int, rows: int) -> int:
    """Shared memory of one backward block at ``rows`` query rows per warp:
    S, P and dP'/dS'/dS of the tile, p' of one head, the tile's q or dO rows
    of one head, two weights and two dW sums, one head's K or V. Same
    formula as ``smem_bytes`` in ``csrc/talking_heads_bwd.cu``."""
    tile = _WARPS * rows
    ps = _round_up4(kv_len)
    floats = 3 * tile * heads * ps + tile * ps + tile * dim + 4 * _round_up4(heads * heads)
    return floats * 4 + kv_len * (dim + 16 // itemsize) * itemsize


def _pick_rows(smem_fn, kv_len: int, heads: int, dim: int, itemsize: int) -> int:
    for rows in (2, 1):
        if smem_fn(kv_len, heads, dim, itemsize, rows) <= SMEM_LIMIT:
            return rows
    return 0


def th_rows(kv_len: int, heads: int, dim: int, itemsize: int) -> int:
    """Query rows per warp the forward launcher picks (``pick_rows``): 2 or
    1, 0 when neither fits shared memory."""
    return _pick_rows(th_smem_bytes, kv_len, heads, dim, itemsize)


def th_bwd_rows(kv_len: int, heads: int, dim: int, itemsize: int) -> int:
    """Query rows per warp the backward launcher picks, 0 when none fits."""
    return _pick_rows(th_bwd_smem_bytes, kv_len, heads, dim, itemsize)


def _shape_ok(heads: int, kv_len: int, dim: int, built=HEADS) -> bool:
    return heads in built and kv_len >= 1 and dim % 8 == 0 and 0 < dim <= MAX_DIM


def fused_eligible(heads: int, kv_len: int, dim: int, *, itemsize: int = 2) -> bool:
    """True when the forward kernel takes the shape: a head count it is
    built for (:data:`HEADS`), a head dim that is a multiple of 8 up to 128,
    and one block's scores and one head's K/V within shared memory (the
    port's rule in bytes, not the TPU's VMEM budget). Holds CaiT-XXS/XS/S at
    224² (L=196, D=48, H=4/6/8) in bf16 and f32."""
    return _shape_ok(heads, kv_len, dim) and th_rows(kv_len, heads, dim, itemsize) > 0


def fused_bwd_eligible(heads: int, q_len: int, kv_len: int, dim: int, *,
                       itemsize: int = 2) -> bool:
    """True when the backward kernel takes the shape: a head count it is
    built for (:data:`BWD_HEADS`, which leaves out 16), the forward's dim
    rule, and S, P and dS of one tile of every head within shared memory.
    Holds CaiT-XXS/XS/S at 224²; CaiT-M trains through the dense recompute."""
    return (
        q_len >= 1
        and _shape_ok(heads, kv_len, dim, BWD_HEADS)
        and th_bwd_rows(kv_len, heads, dim, itemsize) > 0
    )


def resolve_talking_heads_backend(heads: int, kv_len: int, dim: int, *,
                                  dtype=torch.bfloat16,
                                  requested: Optional[str] = None,
                                  dropout: bool = False) -> str:
    """The port's rule, returning ``'fused'`` or ``'xla'``: ``fused`` and
    ``pallas`` mean the kernel (which raises outside its band); ``auto`` /
    None the kernel inside its band and the dense path outside it; ``xla``
    the dense path. A call with attention ``dropout`` takes the dense path
    under ``auto``, and the kernel backends raise, as in ``sav_tpu``."""
    requested = requested or "auto"
    if requested in ("fused", "pallas"):
        if dropout:
            raise ValueError(
                "pallas talking-heads attention is deterministic-only "
                "(attention dropout runs on the XLA path)"
            )
        return "fused"
    if dropout and requested == "auto":
        return "xla"
    if requested == "xla":
        return "xla"
    if requested != "auto":
        raise ValueError(f"unknown attention backend: {requested!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    return "fused" if fused_eligible(heads, kv_len, dim, itemsize=itemsize) else "xla"


# ------------------------------------------------------------ plain versions


def _mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_h W[h, i] · x_h`` over the head axis of ``[B, H, Lq, Lk]``, f32."""
    return torch.einsum("hi,bhqk->biqk", w.float(), x)


def talking_heads_reference(query, key, value, w_pre, w_post, *, scale=None):
    """Plain PyTorch version of the forward kernel, same arithmetic
    (``_th_kernel``): f32 scores scaled after the product, f32 pre-mix with
    f32 weights, exact row softmax divided by its sum, f32 post-mix, p'
    cast to the value dtype before PV, the f32 sum cast to the query dtype."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    p = torch.softmax(_mix(w_pre, s), dim=-1)
    post = _mix(w_post, p).to(value.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", post, value.float()).to(query.dtype)


def talking_heads_bwd_reference(query, key, value, w_pre, w_post, grad, *, scale=None):
    """Plain PyTorch version of the backward kernel, same arithmetic
    (``_th_bwd_kernel``'s equations): S, P and P' recomputed in f32; dO in
    the query dtype; P' cast to the dO dtype before dV, dS to the key dtype
    before dq and dk; every product summed in f32. Returns ``(dq, dk, dv,
    dw_pre, dw_post)`` in the dtypes of their inputs."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    qf, kf, vf = query.float(), key.float(), value.float()
    g = grad.to(query.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(_mix(w_pre, s), dim=-1)
    post = _mix(w_post, p)
    dpost = torch.einsum("bqid,bkid->biqk", g, vf)
    dv = torch.einsum("biqk,bqid->bkid", post.to(query.dtype).float(), g)
    dw_post = torch.einsum("bhqk,biqk->hi", p, dpost)
    dp = torch.einsum("hi,biqk->bhqk", w_post.float(), dpost)
    ds_mixed = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dw_pre = torch.einsum("bhqk,biqk->hi", s, ds_mixed)
    ds = torch.einsum("hi,biqk->bhqk", w_pre.float(), ds_mixed).to(key.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return (dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype),
            dw_pre.to(w_pre.dtype), dw_post.to(w_post.dtype))


def talking_heads_bwd_dq_reference(query, key, value, w_pre, w_post, grad, *, scale=None):
    """Plain PyTorch version of the tensor-core dq kernel: the plain
    backward's arithmetic for dq, dW_pre and dW_post, with p from each row's
    log-sum-exp of the pre-mixed scores; and, per (row, mixed head), that
    lse and delta = rowsum(p ⊙ dP), which the dk/dv kernel reads (f32 [B,
    H, Lq]; the kernel keeps its lse in base 2). Returns ``(dq, dw_pre,
    dw_post, lse, delta)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    qf, kf, vf = query.float(), key.float(), value.float()
    g = grad.to(query.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mixed = _mix(w_pre, s)
    lse = torch.logsumexp(mixed, dim=-1)
    p = torch.exp(mixed - lse[..., None])
    dpost = torch.einsum("bqid,bkid->biqk", g, vf)
    dw_post = torch.einsum("bhqk,biqk->hi", p, dpost)
    dp = torch.einsum("hi,biqk->bhqk", w_post.float(), dpost)
    delta = (p * dp).sum(dim=-1)
    ds_mixed = p * (dp - delta[..., None])
    dw_pre = torch.einsum("bhqk,biqk->hi", s, ds_mixed)
    ds = torch.einsum("hi,biqk->bhqk", w_pre.float(), ds_mixed).to(key.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(query.dtype), dw_pre.to(w_pre.dtype), dw_post.to(w_post.dtype), lse, delta


def talking_heads_bwd_dkv_reference(query, key, value, w_pre, w_post, grad, lse, delta, *,
                                    scale=None):
    """Plain PyTorch version of the tensor-core dk/dv kernel: dk and dv with
    the plain backward's casts, p from the ``lse`` and ``delta`` that
    :func:`talking_heads_bwd_dq_reference` returns. Returns ``(dk, dv)``."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    qf, kf, vf = query.float(), key.float(), value.float()
    g = grad.to(query.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(_mix(w_pre, s) - lse[..., None])
    post = _mix(w_post, p)
    dv = torch.einsum("biqk,bqid->bkid", post.to(query.dtype).float(), g)
    dpost = torch.einsum("bqid,bkid->biqk", g, vf)
    dp = torch.einsum("hi,biqk->bhqk", w_post.float(), dpost)
    ds_mixed = p * (dp - delta[..., None])
    ds = torch.einsum("hi,biqk->bhqk", w_pre.float(), ds_mixed).to(key.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dk.to(key.dtype), dv.to(value.dtype)


def dense_talking_heads(query, key, value, w_pre, w_post, *, scale=None, dropout=None):
    """The dense path (``backend='xla'``), differentiable by autograd: port of
    ``talking_heads_attention`` and ``_th_dense_reference``. q is scaled in
    its own dtype first, the logits are f32 (f32 products of the inputs),
    both mixes and the softmax f32 with the weights in f32, ``dropout``
    (an active dropout layer, when given) on the mixed f32 probabilities,
    which are cast to the value dtype before PV, the output in the query
    dtype."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    # A 0-dim CPU tensor: the scale rounds to q's dtype and reaches a CUDA op as
    # a scalar argument, with no host-to-device copy (legal under graph capture).
    qs = query * torch.tensor(scale, dtype=query.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), key.float())
    probs = _mix(w_post, torch.softmax(_mix(w_pre, logits), dim=-1))
    if dropout is not None:
        probs = dropout(probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(value.dtype).float(), value.float())
    return out.to(query.dtype)


# ----------------------------------------------------------------- kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("talking_heads")
    lib.sav_talking_heads_fwd.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 6,  # q, k, v, wpre, wpost, o
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 12 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_talking_heads_fwd.restype = ctypes.c_int
    lib.sav_talking_heads_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.sav_talking_heads_smem_bytes.restype = ctypes.c_size_t
    lib.sav_talking_heads_rows.argtypes = [ctypes.c_int] * 4
    lib.sav_talking_heads_rows.restype = ctypes.c_int
    lib.sav_talking_heads_has_heads.argtypes = [ctypes.c_int]
    lib.sav_talking_heads_has_heads.restype = ctypes.c_int
    lib.sav_talking_heads_variant.argtypes = [ctypes.c_int] * 3
    lib.sav_talking_heads_variant.restype = ctypes.c_int
    lib.sav_talking_heads_mma_heads_per_warp.argtypes = [ctypes.c_int] * 2
    lib.sav_talking_heads_mma_heads_per_warp.restype = ctypes.c_int
    lib.sav_talking_heads_mma_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.sav_talking_heads_mma_smem_bytes.restype = ctypes.c_size_t
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("talking_heads_bwd")
    lib.sav_talking_heads_bwd.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 6,  # q, k, v, dO, wpre, wpost
        *[ctypes.c_void_p] * 3,  # dq, dk, dv
        *[ctypes.c_void_p] * 4,  # dk_acc, dv_acc, dwpre, dwpost
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 21 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_talking_heads_bwd.restype = ctypes.c_int
    lib.sav_talking_heads_bwd_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.sav_talking_heads_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.sav_talking_heads_bwd_rows.argtypes = [ctypes.c_int] * 4
    lib.sav_talking_heads_bwd_rows.restype = ctypes.c_int
    lib.sav_talking_heads_bwd_has_heads.argtypes = [ctypes.c_int]
    lib.sav_talking_heads_bwd_has_heads.restype = ctypes.c_int
    lib.sav_talking_heads_bwd_mma_heads_per_warp.argtypes = [ctypes.c_int] * 3
    lib.sav_talking_heads_bwd_mma_heads_per_warp.restype = ctypes.c_int
    lib.sav_talking_heads_bwd_mma_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sav_talking_heads_bwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.sav_talking_heads_bwd_mma_rows.argtypes = [ctypes.c_int] * 3
    lib.sav_talking_heads_bwd_mma_rows.restype = ctypes.c_int
    lib.sav_talking_heads_bwd_mma.argtypes = [
        ctypes.c_int,  # kind: 1 dq, 2 dk/dv
        *[ctypes.c_void_p] * 6,  # q, k, v, dO, wpre, wpost
        *[ctypes.c_void_p] * 3,  # dq, dk, dv
        *[ctypes.c_void_p] * 2,  # stats, dw
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),  # 21 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_talking_heads_bwd_mma.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _weights(w_pre, w_post, heads):
    ws = []
    for name, w in (("w_pre", w_pre), ("w_post", w_post)):
        if tuple(w.shape) != (heads, heads):
            raise ValueError(f"{name} must be [H, H] = [{heads}, {heads}], got {tuple(w.shape)}")
        ws.append(w.detach().to(torch.float32).contiguous())
    return ws


def _launch(query, key, value, w_pre, w_post, scale):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = _check_dtypes(query, key, value)
    variant = th_variant(heads, dim, query.element_size())
    # The tensor-core variant also copies q in 16-byte chunks.
    chunked = (("key", key), ("value", value))
    if variant == TENSOR_CORE:
        chunked = (("query", query), *chunked)
    _check_strides((("query", query), ("key", key), ("value", value)), chunked)
    wp, wq = _weights(w_pre, w_post, heads)
    out = torch.empty((batch, q_len, heads, dim), dtype=dtype, device=query.device)
    strides = tuple(s for t in (query, key, value, out) for s in t.stride()[:3])
    lib = _lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_talking_heads_fwd(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            wp.data_ptr(), wq.data_ptr(), out.data_ptr(),
            batch, heads, q_len, kv_len, dim,
            (ctypes.c_int64 * 12)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "talking-heads")
    _count("LAUNCHES", variant)
    return out


def _launch_bwd(query, key, value, w_pre, w_post, grad, scale):
    batch, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    dtype = _check_dtypes(query, key, value)
    variant = th_variant(heads, dim, query.element_size())
    # dO enters in the query dtype (``_th_backward`` casts it); it is read
    # strided and copied only without unit stride on D, or, for the
    # tensor-core kernels, which copy it in 16-byte chunks, without 16-byte
    # aligned rows.
    grad = grad.to(dtype)
    if grad.stride(-1) != 1 or (variant == TENSOR_CORE and not _chunk_aligned(grad)):
        grad = grad.contiguous()
    rows = (("query", query), ("key", key), ("value", value), ("grad", grad))
    # The tensor-core kernels copy every operand in 16-byte chunks.
    _check_strides(rows, rows if variant == TENSOR_CORE else rows[1:3])
    wp, wq = _weights(w_pre, w_post, heads)
    device = query.device
    dq = torch.empty((batch, q_len, heads, dim), dtype=dtype, device=device)
    dk = torch.empty((batch, kv_len, heads, dim), dtype=dtype, device=device)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_int64 * 21)(*(
        s for t in (query, key, value, grad, dq, dk, dv) for s in t.stride()[:3]
    ))
    operands = (query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
                wp.data_ptr(), wq.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    lib = _bwd_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if variant == TENSOR_CORE:
            # The dq kernel writes each row's base-2 lse and delta per mixed
            # head, which the dk/dv kernel reads, and one [2, H, H] partial
            # of dW_pre and dW_post per block: its blocks are the library's
            # own count.
            dq_rows = lib.sav_talking_heads_bwd_mma_rows(1, heads, -(-dim // 16) * 16)
            q_tiles = -(-q_len // dq_rows)
            stats = torch.empty((2, batch, heads, q_len), dtype=torch.float32, device=device)
            parts = torch.empty((batch * q_tiles, 2, heads, heads), dtype=torch.float32,
                                device=device)
            for kind, counter in ((1, "BWD_LAUNCHES"), (2, "BWD_DKV_LAUNCHES")):
                rc = lib.sav_talking_heads_bwd_mma(
                    kind, *operands, stats.data_ptr(), parts.data_ptr(),
                    batch, heads, q_len, kv_len, dim, strides, float(scale), stream,
                )
                _raise_on_error(lib, rc, "talking-heads backward")
                _count(counter, variant)
            dw_pre, dw_post = parts.sum(dim=0).unbind(0)
        else:
            # Per-batch f32 dK/dV sums across q tiles (read only when Lq
            # spans more than one tile) and the per-batch dW partials.
            dk_acc = torch.empty((batch, kv_len, heads, dim), dtype=torch.float32,
                                 device=device)
            dv_acc = torch.empty_like(dk_acc)
            dw_parts = torch.empty((2, batch, heads, heads), dtype=torch.float32, device=device)
            rc = lib.sav_talking_heads_bwd(
                _DTYPE_CODES[dtype], *operands,
                dk_acc.data_ptr(), dv_acc.data_ptr(),
                dw_parts[0].data_ptr(), dw_parts[1].data_ptr(),
                batch, heads, q_len, kv_len, dim, strides, float(scale), stream,
            )
            _raise_on_error(lib, rc, "talking-heads backward")
            _count("BWD_LAUNCHES", variant)
            dw_pre, dw_post = dw_parts.sum(dim=1).unbind(0)
    # The partials are summed in a fixed order (no atomics anywhere).
    return dq, dk, dv, dw_pre.to(w_pre.dtype), dw_post.to(w_post.dtype)


# ---------------------------------------------------------------- wrappers


def _check_shapes(query, key, value) -> None:
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError(
            "talking-heads attention expects [B, L, H, D] inputs, got "
            f"{tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    if key.shape != value.shape or key.shape[0] != query.shape[0] or key.shape[2:] != query.shape[2:]:
        raise ValueError(
            f"mismatched q/k/v shapes {tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )


def talking_heads_bwd(query, key, value, w_pre, w_post, grad, *, scale=None):
    """Gradients of :func:`flash_talking_heads_attention`: ``(dq, dk, dv,
    dw_pre, dw_post)``, each in the dtype of its input. The plain version on
    CPU tensors, the backward kernel on CUDA tensors; raises outside the
    backward's band (:func:`fused_bwd_eligible`)."""
    _check_shapes(query, key, value)
    if scale is None:
        scale = query.shape[-1] ** -0.5
    _, q_len, heads, dim = query.shape
    kv_len = key.shape[1]
    if not fused_bwd_eligible(heads, q_len, kv_len, dim, itemsize=query.element_size()):
        raise ValueError(
            f"heads={heads}, kv_len={kv_len}, head_dim={dim} does not fit the "
            "talking-heads backward kernel: one block would need "
            f"{th_bwd_smem_bytes(kv_len, heads, dim, query.element_size(), 1)} bytes "
            f"of shared memory against {SMEM_LIMIT} (or the head count is not one of {BWD_HEADS})"
        )
    if _device_of(query, key, value, w_pre, w_post, grad) == "cpu":
        return talking_heads_bwd_reference(query, key, value, w_pre, w_post, grad, scale=scale)
    return _launch_bwd(query, key, value, w_pre, w_post, grad, scale)


def _forward(query, key, value, w_pre, w_post, scale):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if query.device.type == "cpu":
        return talking_heads_reference(query, key, value, w_pre, w_post, scale=scale)
    return _launch(query, key, value, w_pre, w_post, scale)


class TalkingHeadsFunction(torch.autograd.Function):
    """Talking-heads attention with a backward (``sav_tpu``'s ``_th``
    custom_vjp): the forward saves q, k, v, w_pre and w_post; the backward
    runs :func:`talking_heads_bwd` inside its band and, outside it,
    differentiates :func:`dense_talking_heads` (``_th_bwd``'s dense
    recompute)."""

    @staticmethod
    def forward(ctx, query, key, value, w_pre, w_post, scale):
        ctx.scale = scale
        ctx.save_for_backward(query, key, value, w_pre, w_post)
        return _forward(query, key, value, w_pre, w_post, scale)

    @staticmethod
    def backward(ctx, grad):
        query, key, value, w_pre, w_post = ctx.saved_tensors
        _, q_len, heads, dim = query.shape
        if fused_bwd_eligible(heads, q_len, key.shape[1], dim, itemsize=query.element_size()):
            grads = talking_heads_bwd(query, key, value, w_pre, w_post, grad, scale=ctx.scale)
        else:
            inputs = [t.detach().requires_grad_() for t in (query, key, value, w_pre, w_post)]
            with torch.enable_grad():
                out = dense_talking_heads(*inputs, scale=ctx.scale)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def flash_talking_heads_attention(query, key, value, w_pre, w_post, *, scale=None):
    """Fused talking-heads attention (see the module docstring).

    Args:
      query, key, value: ``[B, L, H, D]``, all f32 or all bf16.
      w_pre, w_post: ``[H, H]`` head-mixing matrices (``mixed_i = Σ_h
        W[h, i] · head_h``); they enter the kernels in f32.
      scale: logit scale, default ``D ** -0.5``, applied to the f32 product.

    Raises:
      ValueError: a shape outside the forward kernel's band
        (:func:`fused_eligible`); use the dense path there.
    """
    _check_shapes(query, key, value)
    _device_of(query, key, value, w_pre, w_post)
    _, kv_len, heads, dim = key.shape
    itemsize = query.element_size()
    if not fused_eligible(heads, kv_len, dim, itemsize=itemsize):
        raise ValueError(
            f"heads={heads}, kv_len={kv_len}, head_dim={dim} does not fit the "
            f"talking-heads kernel: it takes heads in {HEADS}, head_dim % 8 == 0 "
            f"and <= {MAX_DIM}, and one block needs "
            f"{th_smem_bytes(kv_len, heads, dim, itemsize, 1)} bytes of shared "
            f"memory against {SMEM_LIMIT}; use the dense path (backend='xla')"
        )
    if scale is None:
        scale = dim ** -0.5
    if not requires_backward(query, key, value, w_pre, w_post):
        return _forward(query, key, value, w_pre, w_post, scale)
    return TalkingHeadsFunction.apply(query, key, value, w_pre, w_post, float(scale))
