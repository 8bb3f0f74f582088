"""Blocked (flash) attention for sequences of any length.

Port of :mod:`sav_tpu.ops.flash_attention`. Six kernels, CUDA C++ for
sm_90a built by :mod:`sav_tpu_torch.ops._build`; the three of the plain
flash path:

- ``csrc/flash_attention.cu``, the forward; it replaces the TPU kernel
  ``_kernel`` with its epilogue ``_online_softmax_step``
  (``sav_tpu/ops/flash_attention.py:86`` / ``:57``). Wrapper
  :func:`flash_attention`, plain version :func:`flash_attention_reference`,
  launch counter :data:`LAUNCHES`. Two variants, chosen by dtype
  (:func:`flash_fwd_variant`): bf16 runs on the tensor cores, f32 on the
  CUDA cores in exact f32; :data:`VARIANT_LAUNCHES` tallies each launch
  under its variant too.
- ``csrc/flash_attention_bwd.cu``, two kernels: dq, which replaces
  ``_bwd_dq_kernel`` (``:360``; wrapper :func:`flash_attention_bwd_dq`,
  plain version :func:`flash_bwd_dq_reference`, counter
  :data:`BWD_DQ_LAUNCHES`), and dk/dv, which replaces ``_bwd_dkv_kernel``
  (``:405``; :func:`flash_attention_bwd_dkv`, :func:`flash_bwd_dkv_reference`,
  :data:`BWD_DKV_LAUNCHES`). ``delta = Σ_d dO·O`` is one PyTorch reduction
  before them, as ``sav_tpu`` forms it outside its kernels (``:337``). Both
  take the forward's variants by dtype (:func:`flash_bwd_variant`): bf16
  on the tensor cores, f32 on the CUDA cores in exact f32;
  :data:`BWD_DQ_VARIANT_LAUNCHES` and :data:`BWD_DKV_VARIANT_LAUNCHES`
  tally each launch under its variant too.

When an input requires grad, :func:`flash_attention` runs through
:class:`FlashAttentionFunction`, the counterpart of the ``_flash``
custom_vjp: without a bias the forward keeps the f32 row logsumexp
``[B, H, Lq]`` and the backward runs the dq and dk/dv kernels; with a bias
the forward keeps no lse and the backward is the dense recompute
(:func:`sav_tpu_torch.ops.attention.dense_recompute_bwd`), which also gives
the bias gradient.

BoTNet's 2-D relative-position attention (``:625-1126``) has three kernels
of its own, the same blocked design with the bias built in-kernel from the
compact absolute per-axis logits ``rw_abs [B, H, L, W]`` and
``rh_abs [B, H, L, Hg]``: ``bias[q, kh·W + kw] = rh_abs[q, kh] +
rw_abs[q, kw]``.

- ``csrc/rel_attention.cu`` replaces ``_rel_kernel`` (``:663``): wrapper
  :func:`rel_attention`, plain version :func:`rel_attention_reference`,
  counter :data:`REL_LAUNCHES`. Two variants by dtype
  (:func:`rel_fwd_variant`), as the flash forward's: bf16 on the tensor
  cores, f32 on the CUDA cores; :data:`REL_VARIANT_LAUNCHES` tallies each
  launch under its variant too.
- ``csrc/rel_attention_bwd.cu``: dq with the compact bias gradients
  ``d_rw``/``d_rh``, replacing ``_rel_bwd_dq_kernel`` (``:868``;
  :func:`rel_attention_bwd_dq`, :func:`rel_bwd_dq_reference`,
  :data:`REL_BWD_DQ_LAUNCHES`), and dk/dv, replacing ``_rel_bwd_dkv_kernel``
  (``:913``; :func:`rel_attention_bwd_dkv`, :func:`rel_bwd_dkv_reference`,
  :data:`REL_BWD_DKV_LAUNCHES`). Both take the forward's variants by dtype
  (:func:`rel_bwd_variant`); :data:`REL_BWD_DQ_VARIANT_LAUNCHES` and
  :data:`REL_BWD_DKV_VARIANT_LAUNCHES` tally each launch under its variant
  too.

:func:`flash_botnet_attention` forms the compact logits outside the kernels
(:func:`compact_to_absolute`) and differentiates through
:class:`RelFlashAttentionFunction`, the counterpart of ``_flash_rel``; the
tables' gradients and dq's extra term come from autograd of that einsum.

The TPU's 128-lane broadcast of lse and delta, its padding of the head dim
and of ``rw``/``rh`` to 128, its selection-matrix matmuls (an MXU idiom for
a gather) and its ``block_b`` are TPU layout and are not carried over.

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
    DIM_ALIGN,
    SMEM_LIMIT,
    _check_dtypes,
    _check_strides,
    _DTYPE_CODES,
    _device_of,
    _raise_on_error,
    pad_head_dim,
    padded_dim,
    requires_backward,
)
from sav_tpu_torch.ops.relative import rel_to_abs

# Mirrors kTile and kMaxDim in csrc/flash_tiles.cuh: q rows per block and
# kv rows per tile of the f32 kernels, and the largest head dim.
BLOCK = 64
MAX_DIM = 128
# Row stride, in f32, of a tile of scores (kTile + 4 in the CUDA sources).
_SCORE_LD = BLOCK + 4
# The forward's bf16 variant (kMmaRows in csrc/flash_attention.cu): q rows
# per block; its kv tile is BLOCK, like the f32 variant's.
MMA_ROWS = 128
MMA_BLOCK_KV = BLOCK
# The backward's bf16 variants (kMmaRows and kMmaQTile in
# csrc/flash_attention_bwd.cu): q rows of a dq block and kv rows of a dk/dv
# block, and the q rows of each tile a dk/dv block streams; dq streams kv
# tiles of BLOCK rows.
BWD_MMA_ROWS = 64
BWD_MMA_Q_TILE = 64
# The relative-position dk/dv kernel's bf16 variant streams q tiles of 32
# rows (kMmaQTile in csrc/rel_attention_bwd.cu); its blocks and its dq's are
# BWD_MMA_ROWS rows.
REL_BWD_MMA_Q_TILE = 32
# The forward's variants by dtype, as ``sav_flash_attention_variant`` picks
# them: bf16 on the tensor cores (mma.sync), f32 on the CUDA cores. The
# backward's (``sav_flash_attention_bwd_variant``) and the
# relative-position kernels' (``sav_rel_attention_variant``,
# ``sav_rel_attention_bwd_variant``) follow the same rule.
TENSOR_CORE = "tensor_core"
CUDA_CORE = "cuda_core"

# Kernel launches since the last reset: the forward, the dq kernel and the
# dk/dv kernel, and the same three of the relative-position family; each
# wrapper adds one per launch of its kernel.
LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
REL_LAUNCHES = 0
REL_BWD_DQ_LAUNCHES = 0
REL_BWD_DKV_LAUNCHES = 0
# The launches of each of the six kernels by variant (each also counts in
# its counter above).
VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
REL_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_DQ_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_DKV_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
REL_BWD_DQ_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
REL_BWD_DKV_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
_VARIANT_TALLIES = {"LAUNCHES": VARIANT_LAUNCHES, "REL_LAUNCHES": REL_VARIANT_LAUNCHES,
                    "BWD_DQ_LAUNCHES": BWD_DQ_VARIANT_LAUNCHES,
                    "BWD_DKV_LAUNCHES": BWD_DKV_VARIANT_LAUNCHES,
                    "REL_BWD_DQ_LAUNCHES": REL_BWD_DQ_VARIANT_LAUNCHES,
                    "REL_BWD_DKV_LAUNCHES": REL_BWD_DKV_VARIANT_LAUNCHES}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set the six launch counters and the tallies by variant to 0."""
    global LAUNCHES, BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    global REL_LAUNCHES, REL_BWD_DQ_LAUNCHES, REL_BWD_DKV_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = BWD_DQ_LAUNCHES = BWD_DKV_LAUNCHES = 0
        REL_LAUNCHES = REL_BWD_DQ_LAUNCHES = REL_BWD_DKV_LAUNCHES = 0
        for tally in _VARIANT_TALLIES.values():
            tally.update(dict.fromkeys(tally, 0))


def _count(counter: str, variant: Optional[str] = None) -> None:
    with _LAUNCH_LOCK:
        globals()[counter] += 1
        if variant is not None:
            _VARIANT_TALLIES[counter][variant] += 1


def flash_fwd_variant(itemsize: int) -> str:
    """The forward's variant for inputs of ``itemsize`` bytes: bf16 (2) on
    the tensor cores, f32 (4) on the CUDA cores (no TF32). Same rule as
    ``sav_flash_attention_variant`` in ``csrc/flash_attention.cu``."""
    if itemsize not in (2, 4):
        raise ValueError(f"the flash kernels take float32 or bfloat16, got itemsize {itemsize}")
    return TENSOR_CORE if itemsize == 2 else CUDA_CORE


def flash_bwd_variant(itemsize: int) -> str:
    """The dq and dk/dv kernels' variant for inputs of ``itemsize`` bytes:
    bf16 (2) on the tensor cores, f32 (4) on the CUDA cores (no TF32). Same
    rule as ``sav_flash_attention_bwd_variant`` in
    ``csrc/flash_attention_bwd.cu``."""
    return flash_fwd_variant(itemsize)


def flash_smem_bytes(dim: int, itemsize: int = 4) -> dict:
    """Dynamic shared memory of one block of each kernel for inputs of
    ``itemsize`` bytes. The f32 kernels hold f32 tiles of 64 rows at a row
    stride of ``dim + 4`` and f32 score tiles of 64 × 68: the forward q, k,
    v and p; dq q, dO, k, v and ds; dk/dv k, v, q, dO, p, ds and the q
    tile's lse and delta. The bf16 kernels hold bf16 rows of
    ``round_up(dim, 16) + 8``: the forward a q tile of :data:`MMA_ROWS`
    rows and two stages of k and v tiles of 64 rows; dq the block's
    :data:`BWD_MMA_ROWS` q and dO rows and two stages of 64-row k and v
    tiles; dk/dv the block's :data:`BWD_MMA_ROWS` k and v rows, two stages
    of :data:`BWD_MMA_Q_TILE`-row q and dO tiles and their f32 lse and
    delta. Same formulas as ``smem_bytes``, ``mma_smem_bytes``,
    ``dq_smem_bytes``, ``dkv_smem_bytes``, ``dq_mma_smem_bytes`` and
    ``dkv_mma_smem_bytes`` in the CUDA sources."""
    if flash_fwd_variant(itemsize) == TENSOR_CORE:
        row = (-(-dim // 16) * 16 + 8) * 2
        return {
            "fwd": (MMA_ROWS + 4 * BLOCK) * row,
            "bwd_dq": (2 * BWD_MMA_ROWS + 4 * BLOCK) * row,
            "bwd_dkv": (2 * BWD_MMA_ROWS + 4 * BWD_MMA_Q_TILE) * row + 4 * BWD_MMA_Q_TILE * 4,
        }
    tile = BLOCK * (dim + 4) * 4
    scores = BLOCK * _SCORE_LD * 4
    return {
        "fwd": 3 * tile + scores,
        "bwd_dq": 4 * tile + scores,
        "bwd_dkv": 4 * tile + 2 * scores + 2 * BLOCK * 4,
    }


def flash_eligible(dim: int, itemsize: int = 4) -> bool:
    """True when the kernels take the head dim for inputs of ``itemsize``
    bytes: up to :data:`MAX_DIM` once zero-padded to a multiple of 8
    (:func:`~sav_tpu_torch.ops.fused_attention.padded_dim`, as the wrappers
    pad it), with every block of :func:`flash_smem_bytes` at the padded dim
    within the 227 KB a block may have (at :data:`MAX_DIM` the largest is
    170,496 bytes in f32 and 104,448 in bf16). Every sequence length is
    taken."""
    dim = padded_dim(dim)
    return (
        0 < dim <= MAX_DIM
        and max(flash_smem_bytes(dim, itemsize).values()) <= SMEM_LIMIT
    )


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
    lib.sav_flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sav_flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.sav_flash_attention_variant.argtypes = [ctypes.c_int]
    lib.sav_flash_attention_variant.restype = ctypes.c_int
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
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.sav_flash_attention_bwd_variant.argtypes = [ctypes.c_int]
    lib.sav_flash_attention_bwd_variant.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_dim(dim: int) -> None:
    if not flash_eligible(dim):
        raise ValueError(
            f"head_dim={dim} does not fit the flash kernels: they take head dims "
            f"up to {MAX_DIM}, zero-padded to a multiple of {DIM_ALIGN}"
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
    _count("LAUNCHES", flash_fwd_variant(query.element_size()))
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
    _count("BWD_DQ_LAUNCHES", flash_bwd_variant(query.element_size()))
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
    _count("BWD_DKV_LAUNCHES", flash_bwd_variant(query.element_size()))
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
    CPU tensors, the dq kernel on CUDA tensors; a head dim off the multiple
    of 8 is zero-padded first (:func:`pad_head_dim`)."""
    dim = query.shape[-1]
    _check_dim(dim)
    if dim % DIM_ALIGN:
        return flash_attention_bwd_dq(*pad_head_dim(query, key, value, grad), lse, delta,
                                      scale=scale)[..., :dim]
    if _device_of(query, key, value, grad, lse, delta) == "cpu":
        return flash_bwd_dq_reference(query, key, value, grad, lse, delta, scale=scale)
    return _launch_bwd_dq(query, key, value, grad, lse, delta, scale)


def flash_attention_bwd_dkv(query, key, value, grad, lse, delta, *, scale):
    """``(dk, dv)`` of :func:`flash_attention` (no bias); see
    :func:`flash_attention_bwd_dq`. The dk/dv kernel on CUDA tensors."""
    dim = query.shape[-1]
    _check_dim(dim)
    if dim % DIM_ALIGN:
        dk, dv = flash_attention_bwd_dkv(*pad_head_dim(query, key, value, grad), lse, delta,
                                         scale=scale)
        return dk[..., :dim], dv[..., :dim]
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
      key, value: ``[B, kv_len, heads, head_dim]``, any kv_len; head_dim
        up to :data:`MAX_DIM` (:func:`flash_eligible`); off the multiple of
        8 it runs zero-padded with its own scale (:func:`pad_head_dim`).
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
    if dim % DIM_ALIGN:
        got = flash_attention(*pad_head_dim(query, key, value), bias, scale=scale,
                              with_lse=with_lse)
        return (got[0][..., :dim], got[1]) if with_lse else got[..., :dim]
    if not requires_backward(query, key, value, bias):
        return _forward(query, key, value, bias, scale, with_lse)
    if with_lse:
        raise ValueError("with_lse=True is forward-only; the lse of a differentiated call stays internal")
    return FlashAttentionFunction.apply(query, key, value, bias, float(scale))


# ---------------------------------------------------------------------------
# BoTNet 2-D relative-position attention: kernels #6-#8.
# ---------------------------------------------------------------------------


def rel_fwd_variant(itemsize: int) -> str:
    """The relative-position forward's variant for inputs of ``itemsize``
    bytes: bf16 (2) on the tensor cores, f32 (4) on the CUDA cores (no
    TF32). Same rule as ``sav_rel_attention_variant`` in
    ``csrc/rel_attention.cu``."""
    if itemsize not in (2, 4):
        raise ValueError(f"the relative-position kernels take float32 or bfloat16, "
                         f"got itemsize {itemsize}")
    return TENSOR_CORE if itemsize == 2 else CUDA_CORE


def rel_bwd_variant(itemsize: int) -> str:
    """The relative-position dq and dk/dv kernels' variant for inputs of
    ``itemsize`` bytes, the forward's rule: bf16 (2) on the tensor cores,
    f32 (4) on the CUDA cores (no TF32). Same rule as
    ``sav_rel_attention_bwd_variant`` in ``csrc/rel_attention_bwd.cu``."""
    return rel_fwd_variant(itemsize)


def rel_mma_rows(length: int) -> int:
    """Query rows of one tensor-core forward block: 128 (8 warps of 16) where
    the sequence is longer than one kv tile, else 64 (4 warps): at L=49 a
    128-row block would leave 79 rows idle (``mma_rows``)."""
    return 128 if length > BLOCK else 64


def rel_smem_bytes(dim: int, height: int, width: int, itemsize: int = 4) -> dict:
    """Dynamic shared memory of one block of each relative-position kernel
    for inputs of ``itemsize`` bytes (``rel = width + height``). The f32
    kernels: the flash kernel's f32 tiles (:func:`flash_smem_bytes`) plus
    the q tile's rows of ``rw_abs`` and ``rh_abs`` (64 × rel f32); dq also
    holds its f32 ``d_rw``/``d_rh`` accumulators (as many again). The bf16
    kernels hold bf16 rows of ``round_up(dim, 16) + 8``: the forward a q
    tile of :func:`rel_mma_rows` rows and two stages of 64-row k and v
    tiles, the q tile's f32 rows of ``rw_abs``/``rh_abs`` and the key
    coordinates of two kv tiles (64 int32 each); dq the block's
    :data:`BWD_MMA_ROWS` dO rows and two stages of 64-row k and v tiles (the
    q rows pass through k's second stage into registers), the q tile's f32
    rows of the compact logits and the f32 accumulators, and two kv tiles'
    key coordinates; dk/dv the block's :data:`BWD_MMA_ROWS` k and v rows
    and two stages of :data:`REL_BWD_MMA_Q_TILE`-row q and dO tiles, of
    their f32 lse and delta and of their f32 rows of the compact logits.
    Same formulas as ``smem_bytes`` / ``mma_smem_bytes`` in
    ``csrc/rel_attention.cu`` and ``dq_smem_bytes`` / ``dkv_smem_bytes`` /
    ``dq_mma_smem_bytes`` / ``dkv_mma_smem_bytes`` in
    ``csrc/rel_attention_bwd.cu``."""
    rel = height + width
    if rel_fwd_variant(itemsize) == TENSOR_CORE:
        row = (-(-dim // 16) * 16 + 8) * 2
        q_rows = rel_mma_rows(height * width)
        return {
            "fwd": (q_rows + 4 * BLOCK) * row + q_rows * rel * 4 + 2 * BLOCK * 4,
            "bwd_dq": (BWD_MMA_ROWS + 4 * BLOCK) * row + 2 * BWD_MMA_ROWS * rel * 4
                      + 2 * BLOCK * 4,
            "bwd_dkv": ((2 * BWD_MMA_ROWS + 4 * REL_BWD_MMA_Q_TILE) * row
                        + 4 * REL_BWD_MMA_Q_TILE * 4 + 2 * REL_BWD_MMA_Q_TILE * rel * 4),
        }
    flash = flash_smem_bytes(dim)
    rows = BLOCK * rel * 4
    return {
        "fwd": flash["fwd"] + rows,
        "bwd_dq": flash["bwd_dq"] + 2 * rows,
        "bwd_dkv": flash["bwd_dkv"] + rows,
    }


def rel_eligible(dim: int, height: int, width: int, itemsize: int = 4) -> bool:
    """True when the relative-position kernels take the head dim and grid
    for inputs of ``itemsize`` bytes: a head dim that is a multiple of 8
    up to :data:`MAX_DIM` (these kernels are not padded), and every block
    of :func:`rel_smem_bytes` within the 227 KB a block may have. In f32
    the dq block is the largest, so at head dim 128
    the band is W + Hg ≤ 156 (BoTNet's 14 + 14 and 7 + 7 are well inside;
    2 + 130 fits), at head dim 64 W + Hg ≤ 284; every bf16 block is smaller
    than the f32 dq block, so the bf16 band contains the f32 one."""
    return dim % DIM_ALIGN == 0 and flash_eligible(dim) and max(
        rel_smem_bytes(dim, height, width, itemsize).values()) <= SMEM_LIMIT


def compact_to_absolute(cw: torch.Tensor, ch: torch.Tensor, height: int, width: int):
    """Relative-indexed per-axis logits → absolute-indexed.

    ``cw``: ``[B, heads, L, 2W-1]`` (``cw[..., q, r] = q_vec · rel_w[r]``) →
    ``rw_abs [B, heads, L, W]`` with ``rw_abs[..., q, kw] = cw[..., q,
    kw - qw + W - 1]`` (:func:`~sav_tpu_torch.ops.relative.rel_to_abs`); the
    same for ``ch`` along the height axis → ``rh_abs [B, heads, L, H]``.
    """
    b, h, l, _ = cw.shape
    rw_abs = rel_to_abs(cw.reshape(b, h, height, width, 2 * width - 1)).reshape(b, h, l, width)
    ch_t = ch.reshape(b, h, height, width, 2 * height - 1).transpose(2, 3)
    rh = rel_to_abs(ch_t)  # [b, h, W, H, H] = [b, n, y, x, X]
    rh_abs = rh.permute(0, 1, 3, 2, 4).reshape(b, h, l, height)
    return rw_abs, rh_abs


def expand_relative_bias(rw_abs: torch.Tensor, rh_abs: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """Absolute per-axis logits → the full ``[B, heads, L, L]`` bias,
    ``bias[q, kh·W + kw] = rh_abs[q, kh] + rw_abs[q, kw]``."""
    b, h, l, _ = rw_abs.shape
    return (rh_abs[..., :, None] + rw_abs[..., None, :]).reshape(b, h, l, height * width)


def _rel_grid(rw_abs: torch.Tensor, rh_abs: torch.Tensor) -> tuple:
    """``(height, width)`` from the compact logits' last axes."""
    return rh_abs.shape[-1], rw_abs.shape[-1]


def rel_attention_reference(query, key, value, rw_abs, rh_abs, *, scale, block_kv=BLOCK,
                            with_lse=False):
    """Plain PyTorch version of the forward kernel (``_rel_kernel``): the
    flash forward's plain version (:func:`flash_attention_reference`, the
    kernel's kv tile as ``block_kv``) with the f32 bias
    :func:`expand_relative_bias` added to the scaled f32 scores."""
    height, width = _rel_grid(rw_abs, rh_abs)
    bias = expand_relative_bias(rw_abs.float(), rh_abs.float(), height, width)
    return flash_attention_reference(query, key, value, bias, scale=scale, block_kv=block_kv,
                                     with_lse=with_lse)


def _rel_recompute(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale):
    """``_rel_recompute_ds``: P from the biased f32 scores and the f32 lse,
    ``ds = P·(dO·Vᵀ − delta)``, both f32 ``[B, H, L, L]``."""
    height, width = _rel_grid(rw_abs, rh_abs)
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    s = s + expand_relative_bias(rw_abs.float(), rh_abs.float(), height, width)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", grad.float(), value.float())
    return p, p * (dp - delta.float()[..., None])


def rel_bwd_dq_reference(query, key, value, rw_abs, rh_abs, grad, lse, delta, *, scale):
    """Plain PyTorch version of the dq kernel (``_rel_bwd_dq_kernel``): dq as
    :func:`flash_bwd_dq_reference` forms it, and the f32 ds reduced over
    the key columns that share a width (``d_rw [B, H, L, W]``) or a height
    (``d_rh [B, H, L, Hg]``) coordinate. Returns ``(dq, d_rw, d_rh)``."""
    height, width = _rel_grid(rw_abs, rh_abs)
    _, ds = _rel_recompute(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(key.dtype).float(), key.float()) * scale
    grid = ds.reshape(*ds.shape[:3], height, width)
    return dq.to(query.dtype), grid.sum(-2), grid.sum(-1)


def rel_bwd_dkv_reference(query, key, value, rw_abs, rh_abs, grad, lse, delta, *, scale):
    """Plain PyTorch version of the dk/dv kernel (``_rel_bwd_dkv_kernel``):
    :func:`flash_bwd_dkv_reference`'s casts with the bias recomputed.
    Returns ``(dk, dv)``."""
    p, ds = _rel_recompute(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(grad.dtype).float(), grad.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(query.dtype).float(), query.float()) * scale
    return dk.to(key.dtype), dv.to(value.dtype)


@functools.cache
def _rel_lib() -> ctypes.CDLL:
    lib = _build.load("rel_attention")
    lib.sav_rel_attention_fwd.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 5,  # q, k, v, rw_abs, rh_abs
        ctypes.c_void_p, ctypes.c_void_p,  # o, lse
        *[ctypes.c_int] * 6,  # B, H, L, D, height, width
        ctypes.POINTER(ctypes.c_int64),  # 12 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_rel_attention_fwd.restype = ctypes.c_int
    lib.sav_rel_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sav_rel_attention_smem_bytes.restype = ctypes.c_size_t
    lib.sav_rel_attention_variant.argtypes = [ctypes.c_int]
    lib.sav_rel_attention_variant.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _rel_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rel_attention_bwd")
    lib.sav_rel_attention_bwd_dq.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 8,  # q, k, v, dO, rw_abs, rh_abs, lse, delta
        *[ctypes.c_void_p] * 3,  # dq, d_rw, d_rh
        *[ctypes.c_int] * 6,  # B, H, L, D, height, width
        ctypes.POINTER(ctypes.c_int64),  # 15 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    lib.sav_rel_attention_bwd_dkv.argtypes = [
        ctypes.c_int,  # dtype
        *[ctypes.c_void_p] * 8,  # q, k, v, dO, rw_abs, rh_abs, lse, delta
        *[ctypes.c_void_p] * 2,  # dk, dv
        *[ctypes.c_int] * 6,  # B, H, L, D, height, width
        ctypes.POINTER(ctypes.c_int64),  # 18 strides
        ctypes.c_float,  # scale
        ctypes.c_void_p,  # stream
    ]
    for fn in (lib.sav_rel_attention_bwd_dq, lib.sav_rel_attention_bwd_dkv):
        fn.restype = ctypes.c_int
    for fn in (lib.sav_rel_attention_bwd_dq_smem_bytes, lib.sav_rel_attention_bwd_dkv_smem_bytes):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_size_t
    lib.sav_rel_attention_bwd_variant.argtypes = [ctypes.c_int]
    lib.sav_rel_attention_bwd_variant.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rel(query, key, value, rw_abs, rh_abs) -> tuple:
    """Shapes of a relative-position call; returns ``(height, width)``."""
    if query.ndim != 4 or key.shape != query.shape or value.shape != query.shape:
        raise ValueError(
            "relative-position attention expects q/k/v of one [B, L, H, D] shape, got "
            f"{tuple(query.shape)}/{tuple(key.shape)}/{tuple(value.shape)}"
        )
    batch, length, heads, dim = query.shape
    height, width = _rel_grid(rw_abs, rh_abs)
    if height * width != length:
        raise ValueError(f"L={length} != height*width={height}*{width}")
    for name, t, n in (("rw_abs", rw_abs, width), ("rh_abs", rh_abs, height)):
        if tuple(t.shape) != (batch, heads, length, n):
            raise ValueError(f"{name} must be [B, H, L, {n}], got {tuple(t.shape)}")
    itemsize = query.element_size()
    if not rel_eligible(dim, height, width, itemsize):
        raise ValueError(
            f"head_dim={dim} on a {height}x{width} grid does not fit the relative-position "
            f"kernels: head dims are multiples of 8 up to {MAX_DIM}, and one block needs "
            f"{max(rel_smem_bytes(dim, height, width, itemsize).values())} bytes of shared memory "
            f"against {SMEM_LIMIT}"
        )
    return height, width


def _rel_launch(query, key, value, rw_abs, rh_abs, scale, with_lse):
    batch, length, heads, dim = query.shape
    height, width = _rel_grid(rw_abs, rh_abs)
    dtype = _check_dtypes(query, key, value)
    named = (("query", query), ("key", key), ("value", value))
    _check_strides(named, named)
    rw_abs = rw_abs.float().contiguous()
    rh_abs = rh_abs.float().contiguous()
    out = torch.empty((batch, length, heads, dim), dtype=dtype, device=query.device)
    lse = torch.empty((batch, heads, length), dtype=torch.float32, device=query.device)
    strides = tuple(s for t in (query, key, value, out) for s in t.stride()[:3])
    lib = _rel_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_rel_attention_fwd(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(),
            rw_abs.data_ptr(), rh_abs.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch, heads, length, dim, height, width,
            (ctypes.c_int64 * 12)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "relative-position attention")
    _count("REL_LAUNCHES", rel_fwd_variant(query.element_size()))
    return (out, lse) if with_lse else out


def _rel_launch_bwd_dq(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale):
    batch, length, heads, dim = query.shape
    height, width = _rel_grid(rw_abs, rh_abs)
    dtype, grad, lse, delta = _bwd_operands(query, key, value, grad, lse, delta)
    rw_abs = rw_abs.float().contiguous()
    rh_abs = rh_abs.float().contiguous()
    dq = torch.empty((batch, length, heads, dim), dtype=dtype, device=query.device)
    d_rw = torch.empty((batch, heads, length, width), dtype=torch.float32, device=query.device)
    d_rh = torch.empty((batch, heads, length, height), dtype=torch.float32, device=query.device)
    strides = tuple(s for t in (query, key, value, grad, dq) for s in t.stride()[:3])
    lib = _rel_bwd_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_rel_attention_bwd_dq(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
            rw_abs.data_ptr(), rh_abs.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), d_rw.data_ptr(), d_rh.data_ptr(),
            batch, heads, length, dim, height, width,
            (ctypes.c_int64 * 15)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "relative-position attention dq")
    _count("REL_BWD_DQ_LAUNCHES", rel_bwd_variant(query.element_size()))
    return dq, d_rw, d_rh


def _rel_launch_bwd_dkv(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale):
    batch, length, heads, dim = query.shape
    height, width = _rel_grid(rw_abs, rh_abs)
    dtype, grad, lse, delta = _bwd_operands(query, key, value, grad, lse, delta)
    rw_abs = rw_abs.float().contiguous()
    rh_abs = rh_abs.float().contiguous()
    dk = torch.empty((batch, length, heads, dim), dtype=dtype, device=query.device)
    dv = torch.empty_like(dk)
    strides = tuple(s for t in (query, key, value, grad, dk, dv) for s in t.stride()[:3])
    lib = _rel_bwd_lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.sav_rel_attention_bwd_dkv(
            _DTYPE_CODES[dtype],
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
            rw_abs.data_ptr(), rh_abs.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            batch, heads, length, dim, height, width,
            (ctypes.c_int64 * 18)(*strides),
            float(scale),
            stream,
        )
    _raise_on_error(lib, rc, "relative-position attention dk/dv")
    _count("REL_BWD_DKV_LAUNCHES", rel_bwd_variant(query.element_size()))
    return dk, dv


def rel_attention(query, key, value, rw_abs, rh_abs, *, scale, with_lse=False):
    """Flash attention over ``L = height·width`` tokens with the relative
    bias built from ``rw_abs [B, H, L, W]`` and ``rh_abs [B, H, L, Hg]``
    (f32) inside the kernel. Forward only; the plain version on CPU tensors,
    kernel #6 on CUDA tensors. Returns ``[B, L, H, D]`` in the query dtype
    (and the f32 lse ``[B, H, L]``)."""
    _check_rel(query, key, value, rw_abs, rh_abs)
    if _device_of(query, key, value, rw_abs, rh_abs) == "cpu":
        return rel_attention_reference(query, key, value, rw_abs, rh_abs, scale=scale,
                                       with_lse=with_lse)
    return _rel_launch(query, key, value, rw_abs, rh_abs, scale, with_lse)


def rel_attention_bwd_dq(query, key, value, rw_abs, rh_abs, grad, lse, delta, *, scale):
    """``(dq, d_rw, d_rh)`` of :func:`rel_attention` from its f32 lse and
    ``delta`` (:func:`bwd_delta`), both ``[B, H, L]``; ``d_rw``/``d_rh`` are
    f32 and shaped like ``rw_abs``/``rh_abs``. The plain version on CPU
    tensors, kernel #7 on CUDA tensors."""
    _check_rel(query, key, value, rw_abs, rh_abs)
    if _device_of(query, key, value, rw_abs, rh_abs, grad, lse, delta) == "cpu":
        return rel_bwd_dq_reference(query, key, value, rw_abs, rh_abs, grad, lse, delta,
                                    scale=scale)
    return _rel_launch_bwd_dq(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale)


def rel_attention_bwd_dkv(query, key, value, rw_abs, rh_abs, grad, lse, delta, *, scale):
    """``(dk, dv)`` of :func:`rel_attention`; see
    :func:`rel_attention_bwd_dq`. Kernel #8 on CUDA tensors."""
    _check_rel(query, key, value, rw_abs, rh_abs)
    if _device_of(query, key, value, rw_abs, rh_abs, grad, lse, delta) == "cpu":
        return rel_bwd_dkv_reference(query, key, value, rw_abs, rh_abs, grad, lse, delta,
                                     scale=scale)
    return _rel_launch_bwd_dkv(query, key, value, rw_abs, rh_abs, grad, lse, delta, scale)


class RelFlashAttentionFunction(torch.autograd.Function):
    """Relative-position flash attention with a backward (``sav_tpu``'s
    ``_flash_rel`` custom_vjp): the forward keeps the f32 lse, the backward
    forms delta and runs kernels #7 and #8. Gradients flow to q, k, v and
    the compact ``rw_abs``/``rh_abs``; the dense bias exists in neither
    direction."""

    @staticmethod
    def forward(ctx, query, key, value, rw_abs, rh_abs, scale):
        out, lse = rel_attention(query, key, value, rw_abs, rh_abs, scale=scale, with_lse=True)
        ctx.save_for_backward(query, key, value, rw_abs, rh_abs, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad):
        query, key, value, rw_abs, rh_abs, out, lse = ctx.saved_tensors
        delta = bwd_delta(out, grad)
        operands = (query, key, value, rw_abs, rh_abs, grad, lse, delta)
        dq, d_rw, d_rh = rel_attention_bwd_dq(*operands, scale=ctx.scale)
        dk, dv = rel_attention_bwd_dkv(*operands, scale=ctx.scale)
        return dq, dk, dv, d_rw.to(rw_abs.dtype), d_rh.to(rh_abs.dtype), None


def flash_botnet_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    rel_k_h: torch.Tensor,
    rel_k_w: torch.Tensor,
    height: int,
    width: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """BoTNet attention with the 2-D relative logits inside the kernels.

    Args:
      query/key/value: ``[B, L, heads, D]`` with ``L == height * width``.
      rel_k_h: ``[2·height−1, D]`` height-relative table.
      rel_k_w: ``[2·width−1, D]`` width-relative table.
      scale: content-logit scale, default ``D ** -0.5``, applied to the f32
        product; the relative logits take q scaled in its own dtype, then
        widened to f32, times the f32 tables (``sav_tpu``'s conventions).

    Returns:
      ``[B, L, heads, D]`` in the query dtype, differentiable in all five
      tensors: the kernels' backward gives dq, dk, dv and the compact bias
      gradients, autograd of the compact einsum the rest.
    """
    _, length, _, dim = query.shape
    if length != height * width:
        raise ValueError(f"L={length} != height*width={height * width}")
    if scale is None:
        scale = dim ** -0.5
    # A 0-dim CPU tensor: the scale rounds to q's dtype and reaches a CUDA op as
    # a scalar argument, with no host-to-device copy (legal under graph capture).
    qs = (query * torch.tensor(scale, dtype=query.dtype)).float()
    cw = torch.einsum("blhd,rd->bhlr", qs, rel_k_w.float())
    ch = torch.einsum("blhd,rd->bhlr", qs, rel_k_h.float())
    rw_abs, rh_abs = compact_to_absolute(cw, ch, height, width)
    if not requires_backward(query, key, value, rw_abs, rh_abs):
        return rel_attention(query, key, value, rw_abs, rh_abs, scale=scale)
    return RelFlashAttentionFunction.apply(query, key, value, rw_abs, rh_abs, float(scale))
