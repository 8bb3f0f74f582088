"""Int8 quantized matmuls: the QAT training dot and int8-weight serving
(port of :mod:`sav_tpu.ops.quant`).

The arm quantizes the projection and FFN dots of every family: per-channel
symmetric int8 scales over the contracted axis (``scale = amax / 127``, 1.0
for an all-zero channel), an exact int32 accumulation, and a dequantize by
the product of the two channels' scales. The attention core (QK/AV) stays in
the compute dtype, as ``sav_tpu`` keeps it.

Two hand-written CUDA kernels (CUDA C++ for sm_90a, built by
:mod:`sav_tpu_torch.ops._build`) replace what ``sav_tpu`` leaves to XLA;
neither replaces a ``pallas_call``:

- **Q1**, ``csrc/int8_quant.cu``: the quantize of one operand, reading it
  once. Wrappers :func:`quantize_rows` (one scale per row; the codes keep
  the layout) and :func:`quantize_cols_t` (one scale per column of each
  ``[R, C]`` matrix of a ``[T, R, C]`` tensor; the codes are written
  transposed, ``[T, C, R]``; one read through a cluster of blocks where
  :func:`quant_cols_plan` finds the column strip fits on chip, else two
  passes), plain versions :func:`quantize_rows_reference` and
  :func:`quantize_cols_t_reference`, launch counter :data:`QUANT_LAUNCHES`.
  Round to nearest even, or ``floor(a / scale + u)`` with the uniform draws
  ``u`` passed in (stochastic rounding of the gradient).
- **Q2**, ``csrc/int8_gemm.cu``: ``(f32(Σ_k A[m,k]·B[n,k]) · sa[m]) · sb[n]``
  on the tensor cores (``wgmma`` on s8, operands by TMA, persistent
  blocks), both operands K-contiguous, K cut into the slices of
  :func:`gemm_plan` where the output tiles alone leave SMs idle (split-K).
  Wrapper :func:`int8_gemm`, plain version :func:`int8_gemm_reference`,
  launch counter :data:`GEMM_LAUNCHES` (:data:`GEMM_SPLIT_LAUNCHES` by
  plan).

Both kernels are bit-equal to their plain versions: the quantize repeats the
f32 operations of the reference, and the int32 sum is exact. The codes Q1
writes have rows padded with zeros to a multiple of 16 bytes
(:data:`CODE_ALIGN`), the row stride Q2 reads in 16-byte chunks; an operand
without it is copied into such a layout by :func:`int8_gemm` first.

Every wrapper runs its plain version on CPU tensors, and only there; on CUDA
tensors it launches its kernel or raises. On the CPU the accumulation is a
``torch.int32`` matmul; PyTorch has no integer matmul on CUDA, so the plain
version there sums in float64, which holds every sum of the zoo exactly
(``127² · K`` stays below 2³¹ for K up to Mixer-L's 4096).

On top of the kernels, with ``sav_tpu``'s names and meaning:

- :func:`quantize_channelwise`, :func:`quantize_stochastic` (any contracted
  axes);
- :func:`int8_ste_dot`, the QAT dot: forward on the int8 codes, and a
  backward (a ``torch.autograd.Function``) whose two products, dx and dw,
  run int8 too, with the cotangent rounded stochastically;
  :func:`int8_serve_dot`, the serving dot (f32 out);
- :class:`QuantDense` (mode ``"int8"``, the float ``weight``/``bias`` of
  ``nn.Linear`` through the QAT dot) and :class:`QuantDenseServe` (mode
  ``"int8_serve"``: an int8 ``weight`` ``[out, in]`` and an f32 ``scale``
  ``[out]``), the port's twins of the ``Dense`` layer; the projections the
  port keeps as raw ``[in, ..., out]`` parameters (``to_qkv``, ``to_q``,
  ``to_out``, ...) go through :func:`declare_kernel`,
  :func:`project` and :func:`project_qkv`, which keep the name and
  shape of the parameter and, serving, add a ``<name>_scale`` buffer;
- :func:`quantize_params`, a float ``state_dict`` to the serving one, and
  :func:`is_quantized_template`.

Uniform draws of the backward come from a noise source (:func:`draw_uniform`):
a ``torch.Generator`` (the trainer's ``"quant"`` generator, which the
captured step registers, so every replay rounds anew), ``None`` (the
device's default generator), or a callable ``(shape, kind) -> tensor``
(``kind`` ``"dx"`` or ``"dw"``) through which tests inject ``sav_tpu``'s
draws.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Sequence

import torch
from torch import nn

from sav_tpu_torch.ops import _build

# Symmetric int8: [-127, 127] (-128 is unused, so negation never overflows).
INT8_AMAX = 127.0
MODES = ("int8", "int8_serve")
# Row stride, in bytes, of the codes Q1 writes and Q2 reads.
CODE_ALIGN = 16

TENSOR_CORE = "tensor_core"
CUDA_CORE = "cuda_core"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: Q1 (each quantize call, one to three
# CUDA kernels) and Q2 (each GEMM call, one kernel, or two with split-K).
QUANT_LAUNCHES = 0
GEMM_LAUNCHES = 0
# The same by variant: Q1 runs on the CUDA cores, Q2 on the tensor cores.
QUANT_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
GEMM_VARIANT_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
# Q2's launches by plan: K whole, or cut into slices (split-K).
WHOLE_K, SPLIT_K = "whole_k", "split_k"
GEMM_SPLIT_LAUNCHES = {WHOLE_K: 0, SPLIT_K: 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set both launch counters and their tallies to 0."""
    global QUANT_LAUNCHES, GEMM_LAUNCHES
    with _LAUNCH_LOCK:
        QUANT_LAUNCHES = GEMM_LAUNCHES = 0
        for tally in (QUANT_VARIANT_LAUNCHES, GEMM_VARIANT_LAUNCHES, GEMM_SPLIT_LAUNCHES):
            tally.update(dict.fromkeys(tally, 0))


def _count_quant() -> None:
    global QUANT_LAUNCHES
    with _LAUNCH_LOCK:
        QUANT_LAUNCHES += 1
        QUANT_VARIANT_LAUNCHES[CUDA_CORE] += 1


def _count_gemm(splits: int) -> None:
    global GEMM_LAUNCHES
    with _LAUNCH_LOCK:
        GEMM_LAUNCHES += 1
        GEMM_VARIANT_LAUNCHES[TENSOR_CORE] += 1
        GEMM_SPLIT_LAUNCHES[SPLIT_K if splits > 1 else WHOLE_K] += 1


def _round_up(n: int, k: int = CODE_ALIGN) -> int:
    return -(-n // k) * k


# ----------------------------------------------------------------- plain


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    # A tensor divisor: PyTorch divides by a Python scalar as a product with
    # its reciprocal on CUDA, which is not the IEEE quotient the kernel and
    # sav_tpu take.
    return torch.where(amax > 0.0, amax / torch.full_like(amax, INT8_AMAX),
                       torch.ones_like(amax))


def _codes(a: torch.Tensor, scale: torch.Tensor, noise: Optional[torch.Tensor]):
    v = a / scale
    v = torch.floor(v + noise) if noise is not None else torch.round(v)
    return v.clamp(-INT8_AMAX, INT8_AMAX).to(torch.int8)


def quantize_rows_reference(a: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """``[R, C]`` → codes ``[R, C]`` int8 and scales ``[R]`` f32 (one per
    row; round half to even, or ``floor(a/s + noise)``)."""
    a = a.float()
    scale = _scale_of(a.abs().amax(dim=-1))
    return _codes(a, scale[:, None], noise), scale


def quantize_cols_t_reference(a: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """``[T, R, C]`` → codes ``[T, C, R]`` int8 (transposed) and scales
    ``[T, C]`` f32 (one per column of each ``[R, C]`` matrix)."""
    a = a.float()
    scale = _scale_of(a.abs().amax(dim=1))
    return _codes(a, scale[:, None, :], noise).transpose(1, 2), scale


def _accumulate(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """``Σ_k qa[m,k]·qb[n,k]`` as int32: an int32 matmul on the CPU; on CUDA,
    which has no integer matmul in PyTorch, a float64 one (exact: every sum
    is an integer below 2⁵³)."""
    if qa.device.type == "cpu":
        return torch.matmul(qa.to(torch.int32), qb.to(torch.int32).t())
    return torch.matmul(qa.double(), qb.double().t()).to(torch.int32)


def int8_gemm_reference(qa, qb, sa, sb, out_dtype=torch.float32, *,
                        scale_b_first: bool = False, split: int = 0) -> torch.Tensor:
    """``(f32(Σ_k qa[m,k]·qb[n,k]) · sa[m]) · sb[n]`` (the scales the other
    way round with ``scale_b_first``) in ``out_dtype``; ``split`` > 0 gives
    ``[N / split, M, split]``."""
    acc = _accumulate(qa, qb).float()
    sa, sb = sa.float()[:, None], sb.float()[None, :]
    out = (acc * sb) * sa if scale_b_first else (acc * sa) * sb
    out = out.to(out_dtype)
    if split:
        m, n = out.shape
        out = out.view(m, n // split, split).transpose(0, 1).contiguous()
    return out


# ---------------------------------------------------------------- plans

# The H100 SXM's streaming multiprocessors; on the card the plans take the
# device's own count.
H100_SMS = 132
# Q2's tile (csrc/int8_gemm.cu, `sav_int8_gemm_tile`): output rows and
# columns, and bytes of K a k-tile holds.
GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 128, 128, 128
# The fewest k-tiles a slice of K gets: shorter K is not split.
GEMM_MIN_SLICE_KTILES = 8
# Q1's column path (csrc/int8_quant.cu, `sav_int8_quantize_cols_constant`):
# columns of a strip, bytes of a strip's rows one block may hold, the
# largest cluster, and the row granule of a block; and the strip bytes at
# which two blocks share an SM (its 233,472 bytes of shared memory, less 1 KB
# a block for the system and the 9,344 bytes of a 512-thread block's own).
QUANT_STRIP = 16
QUANT_STRIP_BYTES_MAX = 232_448 - 9_344
QUANT_CLUSTER_MAX = 16
QUANT_TILE_ROWS = 32
QUANT_STRIP_BYTES_PAIR = 233_472 // 2 - 1_024 - 9_344


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> int:
    """Q2's split of K: the number of slices S of whole k-tiles
    (``GEMM_TILE_K`` bytes) an ``[M, K] · [N, K]ᵀ`` product is cut into.

    1 where the output tiles fill the card or K is short (under two slices
    of ``GEMM_MIN_SLICE_KTILES``); otherwise the S, at most two waves of
    (tile, slice) units over the ``sms`` SMs, that minimises the k-tiles
    the busiest SM walks, ``ceil(units / sms) · ceil(ktiles / S)`` (ties to
    the smaller S, which writes fewer partial sums)."""
    tiles = _cdiv(m, GEMM_TILE_M) * _cdiv(n, GEMM_TILE_N)
    ktiles = _cdiv(k, GEMM_TILE_K)
    most = min(ktiles // GEMM_MIN_SLICE_KTILES, (2 * sms) // tiles)
    best, cost = 1, _cdiv(tiles, sms) * ktiles
    for s in range(2, most + 1):
        c = _cdiv(tiles * s, sms) * _cdiv(ktiles, s)
        if c < cost:
            best, cost = s, c
    return best


def gemm_slices(k: int, splits: int) -> list:
    """The k-tile ranges ``[(kt0, kt1), ...]`` of the ``splits`` slices,
    as the kernel cuts them: slice s takes ``[s·kt/S, (s+1)·kt/S)``."""
    ktiles = _cdiv(k, GEMM_TILE_K)
    return [(s * ktiles // splits, (s + 1) * ktiles // splits) for s in range(splits)]


def quant_cols_plan(t: int, rows: int, cols: int, itemsize: int, sms: int = H100_SMS):
    """Q1's column path for a ``[T, R, C]`` input: ``(cluster,
    rows_per_block)`` of the one-read path, a cluster of blocks that holds
    each strip of ``QUANT_STRIP`` columns on chip, or None for two passes.

    A block holds ``ceil16(R) / cluster`` rows, rounded up to
    ``QUANT_TILE_ROWS``, and every block of the cluster some. The smallest
    cluster (1, 2, 4, 8, 16) that gives the card at least ``sms`` blocks,
    each at most ``QUANT_STRIP_BYTES_PAIR`` (two blocks an SM, so one's
    loads run under the other's quantize); failing that, the smallest with
    ``sms`` blocks that fits ``QUANT_STRIP_BYTES_MAX``; failing that, the
    largest that fits."""
    ldc = _round_up(rows)
    strips = _cdiv(cols, QUANT_STRIP)
    options = []
    cluster = 1
    while cluster <= QUANT_CLUSTER_MAX:
        per_block = _round_up(_cdiv(ldc, cluster), QUANT_TILE_ROWS)
        if (cluster - 1) * per_block >= ldc:
            break
        nbytes = per_block * QUANT_STRIP * itemsize
        if nbytes <= QUANT_STRIP_BYTES_MAX:
            options.append((cluster, per_block, nbytes, t * strips * cluster >= sms))
        cluster *= 2
    paired = [o for o in options if o[3] and o[2] <= QUANT_STRIP_BYTES_PAIR]
    enough = [o for o in options if o[3]]
    chosen = paired or enough or options[-1:]
    return chosen[0][:2] if chosen else None


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# --------------------------------------------------------------- kernels


@functools.cache
def _quant_lib() -> ctypes.CDLL:
    lib = _build.load("int8_quant")
    lib.sav_int8_quantize_rows.argtypes = [
        ctypes.c_int,  # dtype
        ctypes.c_void_p, ctypes.c_void_p,  # a, noise
        ctypes.c_void_p, ctypes.c_void_p,  # codes, scales
        ctypes.c_int, ctypes.c_int,  # R, C
        ctypes.c_int64, ctypes.c_int64,  # lda, ldc
        ctypes.c_void_p,  # stream
    ]
    lib.sav_int8_quantize_rows.restype = ctypes.c_int
    lib.sav_int8_quantize_cols_t.argtypes = [
        ctypes.c_int,  # dtype
        ctypes.c_void_p, ctypes.c_void_p,  # a, noise
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # codes, scales, scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T, R, C
        ctypes.c_int64,  # ldc
        ctypes.c_int, ctypes.c_int,  # cluster, rows per block
        ctypes.c_void_p,  # stream
    ]
    lib.sav_int8_quantize_cols_t.restype = ctypes.c_int
    lib.sav_int8_quantize_cols_constant.argtypes = [ctypes.c_int]
    lib.sav_int8_quantize_cols_constant.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _gemm_lib() -> ctypes.CDLL:
    lib = _build.load("int8_gemm")
    lib.sav_int8_gemm.argtypes = [
        ctypes.c_int,  # out dtype
        ctypes.c_void_p, ctypes.c_void_p,  # A, B
        ctypes.c_void_p, ctypes.c_void_p,  # sa, sb
        ctypes.c_void_p, ctypes.c_void_p,  # out, split-K scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, N, K
        ctypes.c_int64, ctypes.c_int64,  # lda, ldb
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scale_b_first, split, splits
        ctypes.c_void_p,  # stream
    ]
    lib.sav_int8_gemm.restype = ctypes.c_int
    lib.sav_int8_gemm_smem_bytes.argtypes = []
    lib.sav_int8_gemm_smem_bytes.restype = ctypes.c_size_t
    lib.sav_int8_gemm_tile.argtypes = [ctypes.c_int]
    lib.sav_int8_gemm_tile.restype = ctypes.c_int
    lib.sav_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sav_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.sav_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_input(a: torch.Tensor, noise: Optional[torch.Tensor], what: str) -> None:
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {a.dtype}")
    if noise is not None and (noise.dtype != torch.float32 or noise.shape != a.shape
                              or noise.device != a.device):
        raise ValueError(f"{what}: noise must be float32 of the input's shape "
                         f"{tuple(a.shape)} on {a.device}, got {noise.dtype} "
                         f"{tuple(noise.shape)} on {noise.device}")


def quantize_rows(a: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """Q1 by rows: ``[R, C]`` (unit stride on C) → ``(codes [R, C] int8,
    scales [R] f32)``. On CUDA the codes are a view of ``[R, ceil16(C)]``
    zero-padded rows."""
    if a.dim() != 2:
        raise ValueError(f"quantize_rows takes [R, C], got {tuple(a.shape)}")
    _check_input(a, noise, "quantize_rows")
    if a.device.type == "cpu":
        return quantize_rows_reference(a, noise)
    if a.stride(1) != 1:
        a = a.contiguous()
    rows, cols = a.shape
    ldc = _round_up(cols)
    codes = torch.empty((rows, ldc), dtype=torch.int8, device=a.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=a.device)
    noise = None if noise is None else noise.contiguous()
    lib = _quant_lib()
    with torch.cuda.device(a.device):
        rc = lib.sav_int8_quantize_rows(
            _DTYPE_CODES[a.dtype], a.data_ptr(),
            None if noise is None else noise.data_ptr(),
            codes.data_ptr(), scales.data_ptr(), rows, cols,
            a.stride(0) if rows > 1 else cols, ldc, _stream(a),
        )
    _raise_on_error(lib, rc, "int8 quantize (rows)")
    _count_quant()
    return codes[:, :cols], scales


def quantize_cols_t(a: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """Q1 by columns, transposed: ``[T, R, C]`` (or ``[R, C]``, as T = 1) →
    ``(codes [T, C, R] int8, scales [T, C] f32)`` (without the T axis for a
    2-D input). On CUDA the codes are a view of ``[T, C, ceil16(R)]``
    zero-padded rows."""
    squeeze = a.dim() == 2
    if squeeze:
        a = a.unsqueeze(0)
        noise = None if noise is None else noise.unsqueeze(0)
    if a.dim() != 3:
        raise ValueError(f"quantize_cols_t takes [T, R, C] or [R, C], got {tuple(a.shape)}")
    _check_input(a, noise, "quantize_cols_t")
    if a.device.type == "cpu":
        codes, scales = quantize_cols_t_reference(a, noise)
    else:
        a = a.contiguous()
        noise = None if noise is None else noise.contiguous()
        t, rows, cols = a.shape
        ldc = _round_up(rows)
        lib = _quant_lib()
        full = torch.empty((t, cols, ldc), dtype=torch.int8, device=a.device)
        scales = torch.empty((t, cols), dtype=torch.float32, device=a.device)
        plan = quant_cols_plan(t, rows, cols, a.element_size(), _sm_count(a.device.index))
        cluster, per_block = plan or (0, 0)
        # Two passes keep each 1,024-row chunk's column maxima.
        scratch = None if plan else torch.empty(
            (t * _cdiv(rows, 1024) * cols,), dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            rc = lib.sav_int8_quantize_cols_t(
                _DTYPE_CODES[a.dtype], a.data_ptr(),
                None if noise is None else noise.data_ptr(),
                full.data_ptr(), scales.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                t, rows, cols, ldc, cluster, per_block, _stream(a),
            )
        _raise_on_error(lib, rc, "int8 quantize (columns)")
        _count_quant()
        codes = full[..., :rows]
    return (codes[0], scales[0]) if squeeze else (codes, scales)


def _gemm_operand(q: torch.Tensor) -> torch.Tensor:
    """``q`` as Q2 reads it: unit stride on K, a 16-byte aligned pointer and
    row stride; otherwise a zero-padded copy."""
    if (q.stride(1) == 1 and q.stride(0) % CODE_ALIGN == 0
            and q.data_ptr() % CODE_ALIGN == 0 and q.stride(0) >= q.shape[1]):
        return q
    rows, k = q.shape
    padded = torch.zeros((rows, _round_up(k)), dtype=torch.int8, device=q.device)
    padded[:, :k] = q
    return padded


def int8_gemm(qa: torch.Tensor, qb: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
              out_dtype: torch.dtype = torch.float32, *, scale_b_first: bool = False,
              split: int = 0) -> torch.Tensor:
    """Q2: ``qa [M, K]`` and ``qb [N, K]`` int8, ``sa [M]`` and ``sb [N]``
    f32 → ``(f32(qa·qbᵀ) · sa) · sb`` in ``out_dtype`` (f32 or bf16),
    ``[M, N]``, or ``[N / split, M, split]`` with ``split`` > 0."""
    if qa.dtype != torch.int8 or qb.dtype != torch.int8 or qa.dim() != 2 or qb.dim() != 2:
        raise ValueError("int8_gemm takes int8 [M, K] and [N, K] codes, got "
                         f"{qa.dtype} {tuple(qa.shape)} and {qb.dtype} {tuple(qb.shape)}")
    (m, k), (n, kb) = qa.shape, qb.shape
    if k != kb or sa.shape != (m,) or sb.shape != (n,):
        raise ValueError(f"int8_gemm shapes disagree: A {tuple(qa.shape)}, B {tuple(qb.shape)}, "
                         f"sa {tuple(sa.shape)}, sb {tuple(sb.shape)}")
    if out_dtype not in _DTYPE_CODES or (split and n % split):
        raise ValueError(f"int8_gemm writes float32 or bfloat16 with N % split == 0, got "
                         f"{out_dtype}, N {n}, split {split}")
    if qa.device.type == "cpu":
        return int8_gemm_reference(qa, qb, sa, sb, out_dtype,
                                   scale_b_first=scale_b_first, split=split)
    qa, qb = _gemm_operand(qa), _gemm_operand(qb)
    sa = sa.to(torch.float32).contiguous()
    sb = sb.to(torch.float32).contiguous()
    shape = (n // split, m, split) if split else (m, n)
    out = torch.empty(shape, dtype=out_dtype, device=qa.device)
    splits = gemm_plan(m, n, k, _sm_count(qa.device.index))
    # Each slice's int32 partial sums, rows padded to 16 bytes.
    scratch = None if splits == 1 else torch.empty(
        (splits, m, _round_up(n, 4)), dtype=torch.int32, device=qa.device)
    lib = _gemm_lib()
    with torch.cuda.device(qa.device):
        rc = lib.sav_int8_gemm(
            _DTYPE_CODES[out_dtype], qa.data_ptr(), qb.data_ptr(), sa.data_ptr(),
            sb.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            m, n, k, qa.stride(0), qb.stride(0), int(scale_b_first), split, splits,
            _stream(qa),
        )
    _raise_on_error(lib, rc, "int8 GEMM")
    _count_gemm(splits)
    return out


# ------------------------------------------------------------ noise


def draw_uniform(source, shape, kind: str, device) -> torch.Tensor:
    """``U[0, 1)`` f32 draws of ``shape`` from ``source``: a
    ``torch.Generator``, ``None`` (the device's default generator) or a
    callable ``(shape, kind) -> tensor`` (``kind`` ``"dx"`` or ``"dw"``)."""
    shape = tuple(shape)
    if source is None or isinstance(source, torch.Generator):
        return torch.rand(shape, generator=source, device=device, dtype=torch.float32)
    return torch.as_tensor(source(shape, kind), dtype=torch.float32).reshape(shape).to(device)


# ------------------------------------------------------ n-d functions


def _rows_view(a: torch.Tensor, axes: Sequence[int]):
    """``a`` with ``axes`` moved last and flattened: ``([R, C], restore)``."""
    axes = sorted(ax % a.dim() for ax in axes)
    keep = [ax for ax in range(a.dim()) if ax not in axes]
    perm = keep + axes
    moved = a.permute(perm)
    rows = moved.reshape(-1, math.prod(a.shape[ax] for ax in axes))
    keep_shape = [a.shape[ax] for ax in keep]
    scale_shape = [1 if ax in axes else a.shape[ax] for ax in range(a.dim())]
    inverse = [perm.index(ax) for ax in range(a.dim())]

    def restore(codes, scale):
        codes = codes.reshape(*keep_shape, *[a.shape[ax] for ax in axes]).permute(inverse)
        return codes.contiguous(), scale.reshape(scale_shape)

    return rows, restore


def quantize_channelwise(a: torch.Tensor, contract_axes: Sequence[int]):
    """Symmetric per-channel int8: the scale reduces over ``contract_axes``
    (keepdims), one per surviving channel. Returns ``(q int8, scale f32)``,
    ``a ≈ q · scale``; all-zero channels get scale 1.0."""
    rows, restore = _rows_view(a, contract_axes)
    codes, scale = quantize_rows(rows)
    return restore(codes, scale)


def quantize_stochastic(a: torch.Tensor, contract_axes: Sequence[int], noise):
    """:func:`quantize_channelwise` with ``floor(a/s + u)``: ``noise`` is the
    ``U[0, 1)`` draws, a tensor of ``a``'s shape, or a source for
    :func:`draw_uniform`."""
    if not torch.is_tensor(noise):
        noise = draw_uniform(noise, a.shape, "dx", a.device)
    rows, restore = _rows_view(a, contract_axes)
    u_rows, _ = _rows_view(noise.to(torch.float32), contract_axes)
    codes, scale = quantize_rows(rows, u_rows.contiguous())
    return restore(codes, scale)


def _matrix(w: torch.Tensor, n_contract: int) -> torch.Tensor:
    return w.reshape(math.prod(w.shape[:n_contract]), -1)


class _Int8Linear(torch.autograd.Function):
    """``x [M, K] · W`` on the int8 codes, W ``[K, N]`` (``kn``) or
    ``[N, K]``; out in x's dtype. Backward: dx from the stochastically
    rounded cotangent (per row) and W re-quantized per in-channel; dw from x
    and the cotangent each quantized per column over M (stochastic for the
    cotangent); dx in x's dtype, dw in W's."""

    @staticmethod
    def forward(ctx, x, w, kn, source):
        qx, sx = quantize_rows(x)
        qw, sw = quantize_cols_t(w) if kn else quantize_rows(w)
        ctx.save_for_backward(x, w)
        ctx.kn, ctx.source = kn, source
        return int8_gemm(qx, qw, sx, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        u_dx = draw_uniform(ctx.source, g.shape, "dx", g.device)
        u_dw = draw_uniform(ctx.source, g.shape, "dw", g.device)
        qg, sg = quantize_rows(g, u_dx)
        # W per in-channel, as the [K, N] operand of dx = g · Wᵀ.
        qwt, swt = quantize_rows(w) if ctx.kn else quantize_cols_t(w)
        dx = int8_gemm(qg, qwt, sg, swt, x.dtype)
        qxt, sxt = quantize_cols_t(x)
        qgt, sgt = quantize_cols_t(g, u_dw)
        if ctx.kn:
            dw = int8_gemm(qxt, qgt, sxt, sgt, w.dtype)
        else:
            # [N, K]: sav_tpu's order, x's scale first.
            dw = int8_gemm(qgt, qxt, sgt, sxt, w.dtype, scale_b_first=True)
        return dx, dw, None, None


class _Int8QKV(torch.autograd.Function):
    """The stacked QKV projection: ``x [M, K]`` against ``w [K, 3·HD]`` →
    ``[3, M, HD]`` in x's dtype, as ``sav_tpu``'s three ``int8_ste_dot``
    calls, one per slice. The forward is one product (the scales are per
    channel, and x's row scale is the same for all three); dw is one too
    (each cotangent column's scale is its own); dx is three, one per slice
    (the cotangent's row scale is the amax over that slice's H·D features),
    summed."""

    @staticmethod
    def forward(ctx, x, w, hd, source):
        qx, sx = quantize_rows(x)
        qw, sw = quantize_cols_t(w)
        ctx.save_for_backward(x, w)
        ctx.hd, ctx.source = hd, source
        return int8_gemm(qx, qw, sx, sw, x.dtype, split=hd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hd, m, k = ctx.hd, x.shape[0], x.shape[1]
        g = g.contiguous()
        u_dx = torch.stack([draw_uniform(ctx.source, (m, hd), "dx", g.device)
                            for _ in range(3)])
        u_dw = torch.stack([draw_uniform(ctx.source, (m, hd), "dw", g.device)
                            for _ in range(3)])
        qg, sg = quantize_rows(g.view(3 * m, hd), u_dx.view(3 * m, hd))
        # Each slice of w per in-channel: the rows of [K·3, HD].
        qw, sw = quantize_rows(w.view(k * 3, hd))
        qw, sw = qw.view(k, 3, hd), sw.view(k, 3)
        dx = None
        for t in range(3):
            part = int8_gemm(qg[t * m:(t + 1) * m], qw[:, t], sg[t * m:(t + 1) * m],
                             sw[:, t].contiguous(), x.dtype)
            dx = part if dx is None else dx + part
        qxt, sxt = quantize_cols_t(x)
        qgt, sgt = quantize_cols_t(g, u_dw)
        dw = int8_gemm(qxt, qgt.reshape(3 * hd, m), sxt, sgt.reshape(3 * hd), w.dtype)
        return dx, dw, None, None


def int8_ste_dot(x: torch.Tensor, w: torch.Tensor, n_contract: int, noise=None):
    """The QAT dot: ``x`` contracts its trailing ``n_contract`` axes against
    the leading ``n_contract`` axes of ``w`` (flax's ``DenseGeneral``
    layout), both quantized per channel, int32-accumulated, dequantized, in
    ``torch.result_type(x, w)``. The backward runs both gradient products in
    int8 with the cotangent rounded stochastically; ``noise`` is the source
    of its draws (:func:`draw_uniform`)."""
    n = int(n_contract)
    dtype = torch.result_type(x, w)
    x, w = x.to(dtype), w.to(dtype)
    lead = x.shape[:x.dim() - n]
    feat = w.shape[n:]
    x2 = x.reshape(-1, _matrix(w, n).shape[0])
    y = _Int8Linear.apply(x2, _matrix(w, n), True, noise)
    return y.reshape(*lead, *feat)


def int8_serve_dot(x: torch.Tensor, q_kernel: torch.Tensor, scale: torch.Tensor,
                   n_contract: int) -> torch.Tensor:
    """The serving dot: pre-quantized int8 weights (``[in..., out...]``)
    with per-channel ``scale`` (the kernel's feature shape), activations
    quantized per row. Returns f32."""
    n = int(n_contract)
    lead = x.shape[:x.dim() - n]
    codes = _matrix(q_kernel, n)
    qx, sx = quantize_rows(x.reshape(-1, codes.shape[0]))
    y = int8_gemm(qx, codes.t().contiguous(), sx, scale.reshape(-1).float())
    return y.reshape(*lead, *q_kernel.shape[n:])


# --------------------------------------------------------------- modules


def check_mode(quant: Optional[str]) -> Optional[str]:
    if quant not in (None, *MODES):
        raise ValueError(f"unknown quant mode {quant!r}; expected one of {MODES} or None")
    return quant


class QuantDense(nn.Linear):
    """The QAT twin of the port's ``Dense`` (mode ``"int8"``): the same
    float ``weight [out, in]`` and ``bias`` (so state dicts carry over),
    the product through the int8 dot in the input's dtype; the weight is
    cast to that dtype before it is quantized, and the bias added after, in
    it (``sav_tpu``'s ``promote_dtype`` order)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.quant_generator = None

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        dtype = inputs.dtype
        x2 = inputs.reshape(-1, self.in_features)
        y = _Int8Linear.apply(x2, self.weight.to(dtype), False, self.quant_generator)
        y = y.view(*inputs.shape[:-1], self.out_features)
        return y if self.bias is None else y + self.bias.to(dtype)


class QuantDenseServe(nn.Module):
    """The serving twin of ``Dense`` (mode ``"int8_serve"``): an int8
    ``weight [out, in]`` and an f32 ``scale [out]`` (buffers, filled by
    :func:`quantize_params`) and the f32 ``bias``; the product in f32 plus
    the bias in f32, then cast to the input's dtype (``sav_tpu``'s order).
    ``scale`` and ``bias`` stay f32 under ``cast_for_compute``."""

    F32_TENSORS = ("scale", "bias")

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        qx, sx = quantize_rows(inputs.reshape(-1, self.in_features))
        y = int8_gemm(qx, self.weight, sx, self.scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(inputs.dtype).view(*inputs.shape[:-1], self.out_features)


def scale_name(name: str) -> str:
    """The buffer that holds the scales of the raw projection ``name``."""
    return f"{name}_scale"


def declare_kernel(module: nn.Module, name: str, shape, n_contract: int,
                   quant: Optional[str]) -> None:
    """Register ``module.<name>``, a raw projection ``[in..., out...]``
    contracting its leading ``n_contract`` axes: a float parameter, or for
    ``"int8_serve"`` int8 codes of that shape and ``<name>_scale`` (the
    feature shape, f32), both buffers, which ``cast_for_compute`` leaves
    as they are (the scale is added to the module's ``F32_TENSORS``)."""
    if quant == "int8_serve":
        module.register_buffer(name, torch.zeros(tuple(shape), dtype=torch.int8))
        module.register_buffer(scale_name(name), torch.ones(tuple(shape[n_contract:])))
        module.F32_TENSORS = (*getattr(module, "F32_TENSORS", ()), scale_name(name))
        if not hasattr(module, "_kmajor_codes"):
            module._kmajor_codes = {}
            module.register_load_state_dict_post_hook(_refresh_kmajor_codes)
    else:
        setattr(module, name, nn.Parameter(torch.empty(tuple(shape))))


def _kmajor_key(codes: torch.Tensor):
    # An inference tensor counts no versions (and takes no in-place write
    # outside inference mode).
    version = 0 if codes.is_inference() else codes._version
    return codes.data_ptr(), version, codes.device, codes.shape


def kmajor_codes(module: nn.Module, name: str, k: int) -> torch.Tensor:
    """The serving codes of the raw projection ``module.<name>`` (``[in...,
    out...]``, ``k`` contracted) as Q2 reads them, ``[out, k]`` K-major: a
    copy made once, outside a captured replay, and made again when the codes
    change (a new tensor, or an in-place write such as ``load_state_dict``,
    whose hook refreshes it in place, so a captured graph reads the new
    codes)."""
    codes = getattr(module, name)
    held = module._kmajor_codes.get(name)
    if held is None or held[0] != _kmajor_key(codes):
        fresh = codes.reshape(k, -1).t()
        # A normal tensor even inside the engine's inference mode, so the
        # hook may write it in place later.
        with torch.inference_mode(False), torch.no_grad():
            if (held is not None and held[1].shape == fresh.shape
                    and held[1].device == fresh.device):
                copy = held[1].copy_(fresh)
            else:
                copy = fresh.contiguous()
        held = module._kmajor_codes[name] = (_kmajor_key(codes), copy)
    return held[1]


def _refresh_kmajor_codes(module: nn.Module, _incompatible) -> None:
    for name, (_, copy) in list(module._kmajor_codes.items()):
        kmajor_codes(module, name, copy.shape[1])


def project(module: nn.Module, name: str, x: torch.Tensor, n_contract: int = 1) -> torch.Tensor:
    """``x`` (trailing axes contracted) against the raw projection
    ``module.<name>`` on ``module.quant``'s arm, in x's dtype: the QAT dot
    (the kernel cast to x's dtype first), or the serving dot cast to x's
    dtype (no bias: the port's raw projections have none)."""
    w = getattr(module, name)
    dtype = x.dtype
    k = math.prod(w.shape[:n_contract])
    x2 = x.reshape(-1, k)
    if module.quant == "int8_serve":
        qx, sx = quantize_rows(x2)
        y = int8_gemm(qx, kmajor_codes(module, name, k), sx,
                      getattr(module, scale_name(name)).reshape(-1), dtype)
    else:
        y = _Int8Linear.apply(x2, w.to(dtype).reshape(k, -1), True, module.quant_generator)
    return y.view(*x.shape[:x.dim() - n_contract], *w.shape[n_contract:])


def project_qkv(module: nn.Module, x2: torch.Tensor, name: str = "to_qkv") -> torch.Tensor:
    """The stacked ``[in, 3, H, D]`` projection of ``x2 [M, in]`` on
    ``module.quant``'s arm → ``[3, M, H·D]`` in x's dtype."""
    w = getattr(module, name)
    k, _, h, d = w.shape
    dtype = x2.dtype
    if module.quant == "int8_serve":
        qx, sx = quantize_rows(x2)
        scale = getattr(module, scale_name(name)).reshape(-1)
        return int8_gemm(qx, kmajor_codes(module, name, k), sx, scale, dtype, split=h * d)
    return _Int8QKV.apply(x2, w.to(dtype).reshape(k, 3 * h * d), h * d, module.quant_generator)


@torch.no_grad()
def init_serving(model: nn.Module) -> None:
    """``sav_tpu``'s init of a serving tree: every int8 code 0, every scale
    1 and every :class:`QuantDenseServe` bias 0 (a model built on the meta
    device has these tensors uninitialised)."""
    for code_key, (scale_key, _) in quantized_keys(model.state_dict()).items():
        model.get_buffer(code_key).zero_()
        model.get_buffer(scale_key).fill_(1.0)
    for module in model.modules():
        if isinstance(module, QuantDenseServe) and module.bias is not None:
            module.bias.zero_()


def set_quant_generator(model: nn.Module, generator) -> int:
    """Give every QAT layer of ``model`` the noise source its backward
    draws from (:func:`draw_uniform`); returns how many there are."""
    layers = [m for m in model.modules() if hasattr(m, "quant_generator")]
    for layer in layers:
        layer.quant_generator = generator
    return len(layers)


# ------------------------------------------------------ tree conversion


def quantized_keys(template: dict) -> dict:
    """``{codes key: (scale key, contracted axes)}`` of a serving
    ``state_dict`` (or one of its shapes/dtypes): every int8 tensor with a
    scale beside it. A ``Dense`` twin's ``weight [out, in]`` contracts its
    last axis; a raw projection ``[in..., out...]`` its leading
    ``ndim - scale.ndim``."""
    out = {}
    for key, value in template.items():
        if getattr(value, "dtype", None) != torch.int8:
            continue
        if (key == "weight" or key.endswith(".weight")) and (
                key[:-len("weight")] + "scale" in template):
            out[key] = (key[:-len("weight")] + "scale", (len(value.shape) - 1,))
        elif scale_name(key) in template:
            scale = template[scale_name(key)]
            out[key] = (scale_name(key), tuple(range(len(value.shape) - len(scale.shape))))
    return out


def is_quantized_template(template: dict) -> bool:
    """True for a ``state_dict`` that declares int8 codes with their scales
    (a serving tree)."""
    return bool(quantized_keys(template))


def quantize_params(params: dict, template: dict) -> dict:
    """A float ``state_dict`` → the serving one that ``template`` (the same
    model built with ``quant="int8_serve"``: its ``state_dict``) declares:
    wherever the template has int8 codes with a scale, the float kernel is
    quantized per channel over its contracted axes (in f32); every other
    entry is copied in the template's dtype."""
    codes = quantized_keys(template)
    scale_keys = {scale for scale, _ in codes.values()}
    out = {}
    for key, value in template.items():
        if key in scale_keys:
            continue
        if key in codes:
            scale_key, axes = codes[key]
            q, s = quantize_channelwise(params[key].float(), axes)
            out[key] = q
            out[scale_key] = s.reshape(template[scale_key].shape)
        else:
            out[key] = params[key].to(value.dtype)
    return out


def quant_report(float_params: dict, quantized: dict) -> dict:
    """The HBM-density proof of ``sav_tpu``'s engine: the bytes of the
    serving tree (int8 codes, f32 scales, every other parameter in f32, as
    ``sav_tpu``'s f32 template holds it) against the same float parameters
    in bf16."""
    codes = quantized_keys(quantized)
    bf16_equiv = sum(t.numel() * 2 for t in float_params.values())
    serving = 0
    for key, t in float_params.items():
        serving += t.numel() * (1 if key in codes else 4)
    serving += sum(quantized[scale].numel() * 4 for scale, _ in codes.values())
    return {
        "weights_dtype": "int8",
        "param_bytes_serving": int(serving),
        "param_bytes_bf16_equiv": int(bf16_equiv),
        "param_bytes_ratio": round(serving / max(bf16_equiv, 1), 4),
    }
