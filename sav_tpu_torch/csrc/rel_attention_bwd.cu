// BoTNet 2-D relative-position flash attention, backward, for Hopper
// (sm_90a): two kernels.
//
// Replaces the TPU kernels `_rel_bwd_dq_kernel` (sav_tpu/ops/
// flash_attention.py:868, pallas_call at :983) and `_rel_bwd_dkv_kernel`
// (:913, pallas_call at :1015), host side `_rel_backward_pallas` (:947),
// with the shared recompute of `_rel_recompute_ds` (:841). They are the
// flash backward kernels (flash_attention_bwd.cu) with the relative bias
// rebuilt from the compact logits rw_abs [B, H, L, W] and rh_abs
// [B, H, L, Hg] (f32) and, in the dq kernel, the bias gradient reduced to
// the same compact shape:
//
//   s     = (q . k) * scale + rw_abs[q, kw] + rh_abs[q, kh]   (c = kh*W + kw)
//   p     = exp(s - lse)             zero on rows and columns past L
//   ds    = p * (dO . v - delta)     f32; delta = sum_d dO * O, formed before
//   dq    = sum over kv of (ds -> k dtype) . k * scale         (dq kernel)
//   d_rw[q, kw] = sum over kh of ds[q, kh*W + kw]   (f32 ds)   (dq kernel)
//   d_rh[q, kh] = sum over kw of ds[q, kh*W + kw]   (f32 ds)   (dq kernel)
//   dv    = sum over q of (p -> dO dtype)^T dO                 (dk/dv kernel)
//   dk    = sum over q of (ds -> q dtype)^T q * scale          (dk/dv kernel)
//
// The roundings sit where the TPU kernels cast; d_rw/d_rh are sums of the
// f32 ds, as `ds @ S_w^T` is there. The [B, H, L, L] bias, its gradient and
// the probabilities never reach device memory.
//
// What bounds them on the H100: at BoTNet-T3's stage-4 train shape with
// L=196 (B=256, H=4, D=128, bf16) dq moves ~304 MB (q, k, v, dO, the compact
// logits, lse and delta in; dq, d_rw, d_rh out) and does three products,
// ~30 GFLOP; dk/dv moves ~332 MB and does four, ~40 GFLOP: both floors are
// the bytes, ~0.09-0.10 ms (in bf16 on the tensor cores the products alone
// would take 0.03-0.04 ms).
//
// Two variants of each kernel, chosen by the C entry points by dtype
// (`sav_rel_attention_bwd_variant`), each counted as one launch of its
// kernel. In both, every output element has one owner, summed in a fixed
// order: no atomics, the same bits on every run. L = 49 is shorter than one
// tile: p is zero on rows and columns past L, so padded query rows add
// nothing to dk, dv, d_rw or d_rh; padded kv rows of a dk/dv block are
// computed and not stored; padded key coordinates are clamped to L - 1.
//
// - bf16: tensor cores (`rel_attention_bwd_dq_mma_kernel`,
//   `rel_attention_bwd_dkv_mma_kernel`), the flash backward's bf16 kernels
//   (flash_attention_bwd.cu) with the relative forward's in-register bias
//   (rel_attention.cu): every product is warp-level mma.sync.m16n8k16 (bf16
//   operands, f32 accumulators; mma_tiles.cuh), each warp owning 16 rows of
//   a 64-row block. S and dP come from one loop over the same B-fragment
//   loads; each thread adds the bias at its own accumulator positions after
//   the scale, in base 2, and forms p by one ex2 and ds in f32 in
//   registers; p and ds, rounded to bf16, are the A operands of the next
//   products straight from the accumulators.
//   dq: one block per (slice, 64 q rows); K and V stream in 64-row tiles
//   through a two-stage cp.async ring, with the key coordinates of each
//   tile (one division by W per column, kept in shared memory). The q rows
//   pass through K's second stage into registers (A fragments for the
//   whole sweep), which leaves room for the q tile's f32 rows of
//   rw_abs/rh_abs (copied once by 4-byte cp.async) and the f32 d_rw/d_rh
//   accumulators within two blocks an SM at D=128. d_rw and d_rh are sums
//   of the f32 ds: each ds is split exactly into three bf16 slices (its
//   8 leading significant bits, the next 8, the last 8), and each slice
//   times a 0/1 selection matrix (built in registers from the key
//   coordinates: B[c][kw] = [kw(c) == kw], the same for kh) is summed on
//   the tensor cores into a per-tile fragment; each thread adds its
//   fragment's entries to the accumulators it alone owns (rows of its
//   warp). 8-column tiles of kw or kh that no column of the kv tile hits
//   are skipped. d_rw/d_rh are written once at the end. This reduction is
//   a large share of dq's time on the H100 (the selection fragments and
//   the slices are ALU work beside 36-48 more mma a tile at 14 x 14), and
//   most of it on wide grids.
//   dk/dv: one block per (slice, 64 kv rows); q tiles of 32 rows with dO,
//   lse, delta and the tile's f32 rows of rw_abs/rh_abs stream through a
//   two-stage cp.async ring; dK and dV accumulate in registers. A thread's
//   two kv rows (g, g + 8) have fixed key coordinates for the whole sweep,
//   so its bias of S^T[kv j][q r] is rw_abs[r][kw_j] + rh_abs[r][kh_j] from
//   the stage's rows. 32-row q tiles (not #5's 64) keep S^T and dP^T at 32
//   registers a thread, so no instantiation spills, and two stages of the
//   rows within two blocks an SM at D=128. On the H100, at BoTNet's L=196,
//   32-row tiles ran a little faster than 64-row ones, and two stages of
//   rows a little faster than one stage copied between the bias and the
//   dV/dK products. Skipping the 16-column steps that lie wholly past L (at
//   L=196 the last q tile holds 4 rows) made both kernels slower, so padded
//   steps are computed.
//   Both kernels are bound by latency, not by the products: 8 warps an SM,
//   and at L=196 the 64-row tiles pad 196 rows and columns to 256, so 41 %
//   of the products fall on padding. wgmma with TMA and producer/consumer
//   warps is the next step.
// - f32: CUDA cores (`rel_attention_bwd_dq_kernel`,
//   `rel_attention_bwd_dkv_kernel`), exact f32 products, no TF32 (tile
//   pieces in flash_tiles.cuh): the flash backward's f32 kernels with the
//   bias rebuilt per tile. dq keeps q, dO and the tile's rw/rh rows in
//   shared memory and streams k and v; each ds tile is written to shared
//   memory in f32 and reduced into f32 accumulators d_rw[r][kw] and
//   d_rh[r][kh], each owned by one thread for the whole sweep and summed
//   over the tile's columns in a fixed order (kw: columns kw, kw + W, ...;
//   kh: the W contiguous columns of that key row), then rounded to the k
//   dtype in place for the dq product. dk/dv computes the transposed
//   scores per q tile, whose rw/rh rows it loads with q, dO, lse and
//   delta. Bound by issued FMA and shared-memory instructions.

#include <math.h>

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* rw;     // [B, H, L, W], contiguous
  const float* rh;     // [B, H, L, Hg], contiguous
  const float* lse;    // [B, H, L], contiguous
  const float* delta;  // [B, H, L], contiguous
  void* dq;
  float* drw;  // [B, H, L, W], contiguous
  float* drh;  // [B, H, L, Hg], contiguous
  void* dk;
  void* dv;
  int B, H, L, D, Hg, W;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};

// ---- f32 on the CUDA cores ----

// Dynamic shared memory of one f32 block (rel = W + Hg). dq: f32 q, dO, k and v
// tiles, the ds tile, the q tile's rw/rh rows and the d_rw/d_rh
// accumulators. dk/dv: f32 k, v, q and dO tiles, the p and ds tiles, the q
// tile's lse and delta and its rw/rh rows.
__host__ __device__ inline size_t dq_smem_bytes(int d, int rel) {
  return 4 * tile_bytes(d) + score_bytes() + 2 * rel_rows_bytes(rel);
}
__host__ __device__ inline size_t dkv_smem_bytes(int d, int rel) {
  return 4 * tile_bytes(d) + 2 * score_bytes() + 2 * kTile * sizeof(float) +
         rel_rows_bytes(rel);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    rel_attention_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int W = p.W;
  const int Hg = p.Hg;
  const int rel = W + Hg;
  float* qs = smem;
  float* dos = qs + kTile * tile_ld(D);
  float* ks = dos + kTile * tile_ld(D);
  float* vs = ks + kTile * tile_ld(D);
  float* dss = vs + kTile * tile_ld(D);
  float* rws = dss + kTile * kLdS;  // [64][W]
  float* rhs = rws + kTile * W;     // [64][Hg]
  float* drw_s = rhs + kTile * Hg;  // [64][W] accumulators
  float* drh_s = drw_s + kTile * W; // [64][Hg] accumulators

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int nq = min(kTile, p.L - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const size_t row0 = (size_t)bh * p.L + q0;

  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  load_tile<T>(qs,
               static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2] +
                   (int64_t)q0 * p.sq[1],
               p.sq[1], nq, D);
  load_tile<T>(dos,
               static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[2] +
                   (int64_t)q0 * p.sdo[1],
               p.sdo[1], nq, D);
  load_rows_f32(rws, p.rw + row0 * W, kTile * W, nq * W);
  load_rows_f32(rhs, p.rh + row0 * Hg, kTile * Hg, nq * Hg);
  for (int i = tid; i < kTile * rel; i += kThreads) drw_s[i] = 0.f;

  float lse[4], delta[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    lse[i] = r < nq ? p.lse[row0 + r] : 0.f;
    delta[i] = r < nq ? p.delta[row0 + r] : 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.L; k0 += kTile) {
    const int nk = min(kTile, p.L - k0);
    __syncthreads();  // the previous tile's k and ds are no longer read
    load_tile<T>(ks, kg + (int64_t)k0 * p.sk[1], p.sk[1], nk, D);
    load_tile<T>(vs, vg + (int64_t)k0 * p.sv[1], p.sv[1], nk, D);
    __syncthreads();

    int kh[4], kw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = c < nk ? k0 + c : 0;
      kh[j] = col / W;
      kw[j] = col - kh[j] * W;
    }

    float s[4][4], dp[4][4];
    tile_dot(qs, ks, D, ty, tx, s);
    tile_dot(dos, vs, D, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x =
            s[i][j] * p.scale + rws[r * W + kw[j]] + rhs[r * Hg + kh[j]];
        const float pr = (r < nq && c < nk) ? expf(x - lse[i]) : 0.f;
        s[i][j] = pr * (dp[i][j] - delta[i]);  // ds, f32
        dss[r * kLdS + c] = s[i][j];
      }
    }
    __syncthreads();  // the f32 ds tile is in place

    // Row sums of ds over the columns that share kw (d_rw) or kh (d_rh).
    // Entry e = r * rel + idx belongs to thread e % kThreads for the whole
    // sweep, so each accumulator has one owner and a fixed order.
    const int kw0 = k0 % W;
    for (int e = tid; e < kTile * rel; e += kThreads) {
      const int r = e / rel;
      const int idx = e - r * rel;
      const float* row = dss + r * kLdS;
      float sum = 0.f;
      if (idx < W) {
        for (int c = (idx - kw0 + W) % W; c < nk; c += W) sum += row[c];
        drw_s[r * W + idx] += sum;
      } else {
        const int khi = idx - W;
        const int lo = max(0, khi * W - k0);
        const int hi = min(nk, khi * W + W - k0);
        for (int c = lo; c < hi; ++c) sum += row[c];
        drh_s[r * Hg + khi] += sum;
      }
    }
    if (Elem<T>::kVec != 4) {  // bf16: round ds to the k dtype for dq
      __syncthreads();        // every row sum has read the f32 tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dss[(4 * ty + i) * kLdS + tx + 16 * j] = Elem<T>::round(s[i][j]);
    }
    __syncthreads();  // every thread's ds is in place
    tile_pv<NU>(dss, ks, D, ty, tx, acc);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[2] +
           (int64_t)q0 * p.sdq[1];
  store_tile<T, NU>(dqg, p.sdq[1], nq, D, ty, tx, acc, p.scale);
  __syncthreads();  // every accumulator is final
  for (int i = tid; i < nq * W; i += kThreads) p.drw[row0 * W + i] = drw_s[i];
  for (int i = tid; i < nq * Hg; i += kThreads)
    p.drh[row0 * Hg + i] = drh_s[i];
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    rel_attention_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int W = p.W;
  const int Hg = p.Hg;
  float* ks = smem;
  float* vs = ks + kTile * tile_ld(D);
  float* qs = vs + kTile * tile_ld(D);
  float* dos = qs + kTile * tile_ld(D);
  float* pts = dos + kTile * tile_ld(D);
  float* dsts = pts + kTile * kLdS;
  float* lse_s = dsts + kTile * kLdS;
  float* delta_s = lse_s + kTile;
  float* rws = delta_s + kTile;  // [64][W], the current q tile's rows
  float* rhs = rws + kTile * W;  // [64][Hg]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kTile;
  const int nk = min(kTile, p.L - k0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  const float* lseg = p.lse + (size_t)bh * p.L;
  const float* deltag = p.delta + (size_t)bh * p.L;
  const float* rwg = p.rw + (size_t)bh * p.L * W;
  const float* rhg = p.rh + (size_t)bh * p.L * Hg;
  load_tile<T>(ks,
               static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2] +
                   (int64_t)k0 * p.sk[1],
               p.sk[1], nk, D);
  load_tile<T>(vs,
               static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2] +
                   (int64_t)k0 * p.sv[1],
               p.sv[1], nk, D);

  // Key coordinates of this thread's kv rows 4*ty + i, fixed for the block
  // (0 on padded rows, which are computed and not stored).
  int kh[4], kw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int jk = 4 * ty + i;
    const int col = jk < nk ? k0 + jk : 0;
    kh[i] = col / W;
    kw[i] = col - kh[i] * W;
  }

  float4 adk[4][NU], adv[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      adk[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      adv[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int q0 = 0; q0 < p.L; q0 += kTile) {
    const int nq = min(kTile, p.L - q0);
    __syncthreads();  // the previous tile's q, dO, rows, p and ds are done
    load_tile<T>(qs, qg + (int64_t)q0 * p.sq[1], p.sq[1], nq, D);
    load_tile<T>(dos, dog + (int64_t)q0 * p.sdo[1], p.sdo[1], nq, D);
    load_rows_f32(rws, rwg + (size_t)q0 * W, kTile * W, nq * W);
    load_rows_f32(rhs, rhg + (size_t)q0 * Hg, kTile * Hg, nq * Hg);
    if (tid < kTile) {
      lse_s[tid] = tid < nq ? lseg[q0 + tid] : 0.f;
      delta_s[tid] = tid < nq ? deltag[q0 + tid] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are the block's kv rows 4*ty + i, columns the
    // tile's q rows tx + 16*j.
    float st[4][4], dpt[4][4];
    tile_dot(ks, qs, D, ty, tx, st);
    tile_dot(vs, dos, D, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jk = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float x =
            st[i][j] * p.scale + rws[r * W + kw[i]] + rhs[r * Hg + kh[i]];
        const float pr = r < nq ? expf(x - lse_s[r]) : 0.f;
        pts[jk * kLdS + r] = Elem<T>::round(pr);
        dsts[jk * kLdS + r] = Elem<T>::round(pr * (dpt[i][j] - delta_s[r]));
      }
    }
    __syncthreads();  // every thread's p and ds are in place
    tile_pv<NU>(pts, dos, D, ty, tx, adv);
    tile_pv<NU>(dsts, qs, D, ty, tx, adk);
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[2] +
           (int64_t)k0 * p.sdk[1];
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[2] +
           (int64_t)k0 * p.sdv[1];
  store_tile<T, NU>(dkg, p.sdk[1], nk, D, ty, tx, adk, p.scale);
  store_tile<T, NU>(dvg, p.sdv[1], nk, D, ty, tx, adv, 1.f);
}

template <typename T, int NU>
int launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(p.D, p.W + p.Hg);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bwd_dq_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.L + kTile - 1) / kTile);
  rel_attention_bwd_dq_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NU>
int launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(p.D, p.W + p.Hg);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bwd_dkv_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.L + kTile - 1) / kTile);
  rel_attention_bwd_dkv_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_f32(const Params& p, bool dkv, cudaStream_t stream) {
  if (dkv)
    return p.D <= 64 ? launch_dkv<float, 1>(p, stream)
                     : launch_dkv<float, 2>(p, stream);
  return p.D <= 64 ? launch_dq<float, 1>(p, stream)
                   : launch_dq<float, 2>(p, stream);
}

// ---- bf16 on the tensor cores ----

constexpr int kMmaRows = 64;              // q rows (dq), kv rows (dk/dv)
constexpr int kMmaWarps = kMmaRows / 16;  // 16 rows a warp
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaQTile = 32;             // q rows a dk/dv tile streams
constexpr int kGradChunk = 4;  // 8-column tiles of d_rw/d_rh summed at once

// Dynamic shared memory of one bf16 block at head dim d and rel = W + Hg,
// bf16 rows of round_up16(d) + 8. dq: the block's dO rows and two stages of
// k and v tiles (the q rows pass through k's second stage), the q tile's
// f32 rows of rw_abs/rh_abs and the f32 d_rw/d_rh accumulators, the key
// coordinates of two kv tiles. dk/dv: the block's k and v rows and two
// stages of q and dO tiles, of their f32 lse and delta and of their f32
// rw_abs/rh_abs rows.
__host__ __device__ inline size_t dq_mma_smem_bytes(int d, int rel) {
  return (size_t)(kMmaRows + 4 * kTile) * (round_up16(d) + 8) * sizeof(bf16) +
         2 * (size_t)kMmaRows * rel * sizeof(float) + 2 * kTile * sizeof(int);
}
__host__ __device__ inline size_t dkv_mma_smem_bytes(int d, int rel) {
  return (size_t)(2 * kMmaRows + 4 * kMmaQTile) * (round_up16(d) + 8) *
             sizeof(bf16) +
         4 * kMmaQTile * sizeof(float) +
         2 * (size_t)kMmaQTile * rel * sizeof(float);
}

// x with every bit below its 8 leading significant bits cleared: a bf16
// value, and x - trunc_bf16(x) is exact in f32.
__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// Two f32 that hold bf16 values, packed as bf16 (`lo` in the low half).
__device__ __forceinline__ uint32_t pack_upper(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The A operands (as acc_to_a lays out c0, c1) of three bf16 slices whose
// sum is exactly the f32 accumulators: the 8 leading significant bits of
// each element, the next 8 and the last 8. A product of the three with an
// exact (0/1) B operand sums the f32 values, not their bf16 roundings.
__device__ __forceinline__ void acc_to_a_exact(uint32_t a[3][4],
                                               const float c0[4],
                                               const float c1[4]) {
  float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int sl = 0; sl < 3; ++sl) {
    float hi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hi[e] = trunc_bf16(x[e]);
      x[e] -= hi[e];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) a[sl][r] = pack_upper(hi[2 * r], hi[2 * r + 1]);
  }
}

// 1.0 (bf16) in the low half where `lo`, in the high half where `hi`: a pair
// of entries of a 0/1 selection matrix as an mma B operand.
__device__ __forceinline__ uint32_t select2(bool lo, bool hi) {
  return (lo ? 0x3f80u : 0u) | (hi ? 0x3f800000u : 0u);
}

// True when some column of a kv tile of nk consecutive columns of a
// w-wide grid, whose first and last have the key coordinates `first` and
// `last` (kh << 16 | kw), has its kw or (`height`) its kh in [n0, n0 + 8).
__device__ __forceinline__ bool grad_tile_hit(bool height, int n0, int first,
                                              int last, int nk, int W) {
  if (height) return n0 <= (last >> 16) && n0 + 7 >= (first >> 16);
  if (nk >= W) return true;
  const int lo = first & 0xffff;
  const int hi = lo + nk - 1;  // past W - 1 when the columns wrap
  return (n0 <= min(hi, W - 1) && n0 + 7 >= lo) || (hi >= W && n0 <= hi - W);
}

template <int DK>
__global__ void __launch_bounds__(kMmaThreads, DK <= 64 ? 3 : 2)
    rel_attention_bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = DK + 8;     // bf16 row stride of every tile
  constexpr int NT = DK / 8;     // 8-column tiles of dQ
  constexpr int KS = DK / 16;    // k-steps of S and dP
  constexpr int ST = kTile / 8;  // 8-column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int L = p.L;
  const int W = p.W;
  const int Hg = p.Hg;
  bf16* dos = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = dos + kMmaRows * LD;  // [2][kTile][LD]
  bf16* vs = ks + 2 * kTile * LD;  // [2][kTile][LD]
  float* rws = reinterpret_cast<float*>(vs + 2 * kTile * LD);  // [64][W]
  float* rhs = rws + kMmaRows * W;                               // [64][Hg]
  float* drw_s = rhs + kMmaRows * Hg;   // [64][W] accumulators
  float* drh_s = drw_s + kMmaRows * W;  // [64][Hg] accumulators
  int* kcs = reinterpret_cast<int*>(drh_s + kMmaRows * Hg);  // [2][kTile]
  bf16* qs = ks + kTile * LD;  // the q rows, until they are in registers

  const int qtiles = (L + kMmaRows - 1) / kMmaRows;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kMmaRows;
  const int nq = min(kMmaRows, L - q0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the block
  const bool active = wrow < nq;
  const size_t row0 = (size_t)bh * L + q0;

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const int ntiles = (L + kTile - 1) / kTile;
  load_tile_async<kMmaThreads>(
      qs, LD,
      static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[2] +
          (int64_t)q0 * p.sq[1],
      p.sq[1], kMmaRows, nq, DK, D);
  load_tile_async<kMmaThreads>(
      dos, LD,
      static_cast<const bf16*>(p.dout) + b * p.sdo[0] + h * p.sdo[2] +
          (int64_t)q0 * p.sdo[1],
      p.sdo[1], kMmaRows, nq, DK, D);
  load_tile_async<kMmaThreads>(ks, LD, kg, p.sk[1], kTile, min(kTile, L), DK,
                               D);
  load_tile_async<kMmaThreads>(vs, LD, vg, p.sv[1], kTile, min(kTile, L), DK,
                               D);
  // The q tile's rows of the compact logits (zero past L).
  for (int i = tid; i < kMmaRows * W; i += kMmaThreads)
    cp_async4(rws + i, i < nq * W ? p.rw + row0 * W + i : p.rw, i < nq * W);
  for (int i = tid; i < kMmaRows * Hg; i += kMmaThreads)
    cp_async4(rhs + i, i < nq * Hg ? p.rh + row0 * Hg + i : p.rh, i < nq * Hg);
  cp_async_commit();
  for (int i = tid; i < kMmaRows * (W + Hg); i += kMmaThreads) drw_s[i] = 0.f;
  if (tid < kTile) kcs[tid] = key_coord(tid, L, W);
  cp_async_wait<0>();
  __syncthreads();

  // The warp's Q fragments, for the whole sweep; then k's second stage is
  // free for the next tile.
  uint32_t qf[KS][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      load_a(qf[kk], qs + wrow * LD + kk * 16, LD, lane);
  }
  __syncthreads();

  // The lse (base 2) and delta of the thread's rows g and g + 8, and their
  // rows of the compact logits and of the accumulators.
  const float scale2 = p.scale * kLog2e;
  float lse2[2], delta[2];
  const float* rw_row[2];
  const float* rh_row[2];
  float* drw_row[2];
  float* drh_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    lse2[i] = r < nq ? p.lse[row0 + r] * kLog2e : 0.f;
    delta[i] = r < nq ? p.delta[row0 + r] : 0.f;
    rw_row[i] = rws + r * W;
    rh_row[i] = rhs + r * Hg;
    drw_row[i] = drw_s + r * W;
    drh_row[i] = drh_s + r * Hg;
  }
  const int ntw = (W + 7) >> 3;          // 8-column tiles of d_rw
  const int ngrad = ntw + ((Hg + 7) >> 3);  // ... and of d_rh after them

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = (t + 1) * kTile;
      const int n1 = min(kTile, L - k1);
      load_tile_async<kMmaThreads>(ks + (stage ^ 1) * kTile * LD, LD,
                                   kg + (int64_t)k1 * p.sk[1], p.sk[1], kTile,
                                   n1, DK, D);
      load_tile_async<kMmaThreads>(vs + (stage ^ 1) * kTile * LD, LD,
                                   vg + (int64_t)k1 * p.sv[1], p.sv[1], kTile,
                                   n1, DK, D);
      if (tid < kTile) kcs[(stage ^ 1) * kTile + tid] = key_coord(k1 + tid, L, W);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if (active) {
      const bf16* kt = ks + stage * kTile * LD;
      const bf16* vt = vs + stage * kTile * LD;
      const int* kc = kcs + stage * kTile;
      const int k0 = t * kTile;
      const int nk = min(kTile, L - k0);

      // S = Q.K^T and dP = dO.V^T for the warp's 16 rows and the tile's 64
      // columns.
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t da[4];
        load_a(da, dos + wrow * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < ST / 2; ++jp) {
          uint32_t kb[4], vb[4];
          load_b2(kb, kt + (jp * 16) * LD + kk * 16, LD, lane);
          load_b2(vb, vt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
          mma_bf16(dp[2 * jp], da, vb[0], vb[1]);
          mma_bf16(dp[2 * jp + 1], da, vb[2], vb[3]);
        }
      }

      // The scale, the bias rw_abs[q, kw] + rh_abs[q, kh] and the lse in
      // base 2, P by one ex2 (0 on columns past L, the last tile only), then
      // dS = P (dP - delta), in f32, into s.
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const int2 cc = *reinterpret_cast<const int2*>(kc + j * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int code = (e & 1) ? cc.y : cc.x;
          const int i = e >> 1;
          const float bias = rw_row[i][code & 0xffff] + rh_row[i][code >> 16];
          float pr = exp2_approx(
              fmaf(bias, kLog2e, fmaf(s[j][e], scale2, -lse2[i])));
          if (nk < kTile && j * 8 + 2 * t4 + (e & 1) >= nk) pr = 0.f;
          s[j][e] = pr * (dp[j][e] - delta[i]);
        }
      }

      // dQ += (dS -> bf16) . K: 16 kv rows per k-step, dS from registers.
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t kb[4];
          load_b2_trans(kb, kt + (kk * 16) * LD + jp * 16, LD, lane);
          mma_bf16(dq[2 * jp], a, kb[0], kb[1]);
          mma_bf16(dq[2 * jp + 1], a, kb[2], kb[3]);
        }
      }

      // d_rw += dS . S_w and d_rh += dS . S_h over the tile's columns, with
      // the f32 dS in three exact bf16 slices and the selection matrices
      // S_w[c][kw] = [kw(c) == kw], S_h[c][kh] = [kh(c) == kh] as B
      // operands; kGradChunk 8-column tiles of kw (then kh) at a time, those
      // no column of the tile hits skipped.
      const int first = kc[0];
      const int last = kc[nk - 1];
      for (int n0 = 0; n0 < ngrad; n0 += kGradChunk) {
        float f[kGradChunk][4];
        bool hit[kGradChunk];
#pragma unroll
        for (int u = 0; u < kGradChunk; ++u) {
          const int nt = n0 + u;
          hit[u] = nt < ngrad && grad_tile_hit(nt >= ntw, 8 * (nt < ntw ? nt : nt - ntw),
                                               first, last, nk, W);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[u][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < ST / 2; ++kk) {
          uint32_t a[3][4];
          acc_to_a_exact(a, s[2 * kk], s[2 * kk + 1]);
          // Key coordinates of the B rows this thread holds: columns
          // 16kk + 2t4 (+1) and 16kk + 8 + 2t4 (+1).
          const int2 ca = *reinterpret_cast<const int2*>(kc + kk * 16 + 2 * t4);
          const int2 cb =
              *reinterpret_cast<const int2*>(kc + kk * 16 + 8 + 2 * t4);
#pragma unroll
          for (int u = 0; u < kGradChunk; ++u) {
            if (!hit[u]) continue;  // the same for the whole warp
            const int nt = n0 + u;
            const bool height = nt >= ntw;
            const int shift = height ? 16 : 0;
            const int n = 8 * (height ? nt - ntw : nt) + g;
            const uint32_t b0 = select2(((ca.x >> shift) & 0xffff) == n,
                                        ((ca.y >> shift) & 0xffff) == n);
            const uint32_t b1 = select2(((cb.x >> shift) & 0xffff) == n,
                                        ((cb.y >> shift) & 0xffff) == n);
#pragma unroll
            for (int sl = 0; sl < 3; ++sl) mma_bf16(f[u], a[sl], b0, b1);
          }
        }
        // Each fragment entry (row g or g + 8, column 2t4 or 2t4 + 1) has
        // one owner: this thread adds it to its accumulator.
#pragma unroll
        for (int u = 0; u < kGradChunk; ++u) {
          if (!hit[u]) continue;
          const int nt = n0 + u;
          const bool height = nt >= ntw;
          const int len = height ? Hg : W;
          const int n = 8 * (height ? nt - ntw : nt) + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n + (e & 1);
            float* acc = height ? drh_row[e >> 1] : drw_row[e >> 1];
            if (c < len) acc[c] += f[u][e];
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (active) {
    bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq[0] + h * p.sdq[2] +
                (int64_t)q0 * p.sdq[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g + 8 * i;
      if (r >= nq) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t4;
        if (c < D)
          *reinterpret_cast<uint32_t*>(dqg + r * p.sdq[1] + c) = pack_bf16(
              dq[j][2 * i] * p.scale, dq[j][2 * i + 1] * p.scale);
      }
    }
  }
  // The loop's last barrier has made every accumulator final.
  for (int i = tid; i < nq * W; i += kMmaThreads) p.drw[row0 * W + i] = drw_s[i];
  for (int i = tid; i < nq * Hg; i += kMmaThreads)
    p.drh[row0 * Hg + i] = drh_s[i];
}

template <int DK>
__global__ void __launch_bounds__(kMmaThreads, DK <= 64 ? 3 : 2)
    rel_attention_bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = DK + 8;         // bf16 row stride of every tile
  constexpr int NT = DK / 8;         // 8-column tiles of dK and dV
  constexpr int KS = DK / 16;        // k-steps of S^T and dP^T
  constexpr int QT = kMmaQTile / 8;  // 8-column tiles of a q tile
  constexpr bool kHold = DK <= 64;   // K and V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int L = p.L;
  const int W = p.W;
  const int Hg = p.Hg;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kMmaRows * LD;
  bf16* qts = vs + kMmaRows * LD;         // [2][kMmaQTile][LD]
  bf16* dots = qts + 2 * kMmaQTile * LD;  // [2][kMmaQTile][LD]
  // [2][2][kMmaQTile]: per stage the tile's lse, then its delta.
  float* rows_s = reinterpret_cast<float*>(dots + 2 * kMmaQTile * LD);
  // [2][kMmaQTile][W + Hg]: per stage the tile's rows of rw_abs ([.][W]),
  // then of rh_abs ([.][Hg]).
  float* rel_s = rows_s + 4 * kMmaQTile;
  const int rel_stage = kMmaQTile * (W + Hg);

  const int kvtiles = (L + kMmaRows - 1) / kMmaRows;
  const int bh = blockIdx.x / kvtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = (blockIdx.x - bh * kvtiles) * kMmaRows;
  const int nk = min(kMmaRows, L - k0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv0 = warp * 16;  // the warp's first kv row in the block
  const bool active = kv0 < nk;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  const float* lseg = p.lse + (size_t)bh * L;
  const float* deltag = p.delta + (size_t)bh * L;
  const float* rwg = p.rw + (size_t)bh * L * W;
  const float* rhg = p.rh + (size_t)bh * L * Hg;
  const int ntq = (L + kMmaQTile - 1) / kMmaQTile;

  // q, dO, lse, delta and the rows of rw_abs and rh_abs of q tile `t`
  // into `stage`, zero past L.
  auto load_q_tile = [&](int t, int stage) {
    const int q0 = t * kMmaQTile;
    const int n = min(kMmaQTile, L - q0);
    load_tile_async<kMmaThreads>(qts + stage * kMmaQTile * LD, LD,
                                 qg + (int64_t)q0 * p.sq[1], p.sq[1],
                                 kMmaQTile, n, DK, D);
    load_tile_async<kMmaThreads>(dots + stage * kMmaQTile * LD, LD,
                                 dog + (int64_t)q0 * p.sdo[1], p.sdo[1],
                                 kMmaQTile, n, DK, D);
    for (int i = tid; i < 2 * kMmaQTile; i += kMmaThreads) {
      const int r = i < kMmaQTile ? i : i - kMmaQTile;
      const float* src = (i < kMmaQTile ? lseg : deltag) + q0 + r;
      cp_async4(rows_s + stage * 2 * kMmaQTile + i, r < n ? src : lseg,
                r < n);
    }
    float* rws = rel_s + stage * rel_stage;
    for (int i = tid; i < kMmaQTile * W; i += kMmaThreads)
      cp_async4(rws + i, i < n * W ? rwg + (size_t)q0 * W + i : rwg, i < n * W);
    float* rhs = rws + kMmaQTile * W;
    for (int i = tid; i < kMmaQTile * Hg; i += kMmaThreads)
      cp_async4(rhs + i, i < n * Hg ? rhg + (size_t)q0 * Hg + i : rhg,
                i < n * Hg);
  };

  load_tile_async<kMmaThreads>(
      ks, LD,
      static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2] +
          (int64_t)k0 * p.sk[1],
      p.sk[1], kMmaRows, nk, DK, D);
  load_tile_async<kMmaThreads>(
      vs, LD,
      static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2] +
          (int64_t)k0 * p.sv[1],
      p.sv[1], kMmaRows, nk, DK, D);
  load_q_tile(0, 0);
  cp_async_commit();

  // The thread's kv rows g and g + 8 have fixed key coordinates (kh, kw)
  // for the whole sweep (padded rows clamped to the last key): its bias of
  // column r of a q tile is rw_abs[r][kw] + rh_abs[r][kh], at these offsets
  // of the stage's rows.
  int rw_off[2], rh_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int code = key_coord(k0 + kv0 + g + 8 * i, L, W);
    rw_off[i] = code & 0xffff;
    rh_off[i] = kMmaQTile * W + (code >> 16);
  }

  const float scale2 = p.scale * kLog2e;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  uint32_t kf[KS][4], vf[KS][4];  // held fragments (kHold only)

  for (int t = 0; t < ntq; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntq) load_q_tile(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if constexpr (kHold) {
      if (t == 0 && active) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          load_a(kf[kk], ks + kv0 * LD + kk * 16, LD, lane);
          load_a(vf[kk], vs + kv0 * LD + kk * 16, LD, lane);
        }
      }
    }
    if (active) {
      const bf16* qt = qts + stage * kMmaQTile * LD;
      const bf16* dt = dots + stage * kMmaQTile * LD;
      const float* lse_s = rows_s + stage * 2 * kMmaQTile;
      const float* delta_s = lse_s + kMmaQTile;
      const float* rel = rel_s + stage * rel_stage;
      const int nq = min(kMmaQTile, L - t * kMmaQTile);

      // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 kv rows by the tile's
      // q columns.
      float st[QT][4], dpt[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          load_a(ka, ks + kv0 * LD + kk * 16, LD, lane);
          load_a(va, vs + kv0 * LD + kk * 16, LD, lane);
        }
#pragma unroll
        for (int jp = 0; jp < QT / 2; ++jp) {
          uint32_t qb[4], gb[4];
          load_b2(qb, qt + (jp * 16) * LD + kk * 16, LD, lane);
          load_b2(gb, dt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(st[2 * jp], ka, qb[0], qb[1]);
          mma_bf16(st[2 * jp + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[2 * jp], va, gb[0], gb[1]);
          mma_bf16(dpt[2 * jp + 1], va, gb[2], gb[3]);
        }
      }

      // The scale, the bias and the lse in base 2, P^T by one ex2 (0 on q
      // columns past L, the last tile only), and dS^T = P^T (dP^T - delta),
      // in f32.
#pragma unroll
      for (int j = 0; j < QT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t4 + (e & 1);
          const int i = e >> 1;
          const float bias = rel[c * W + rw_off[i]] + rel[c * Hg + rh_off[i]];
          float pr = exp2_approx(fmaf(bias - lse_s[c], kLog2e, st[j][e] * scale2));
          if (nq < kMmaQTile && c >= nq) pr = 0.f;
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - delta_s[c]);
        }
      }

      // dV += (P^T -> bf16) . dO and dK += (dS^T -> bf16) . Q over the
      // tile's q rows, 16 per k-step, A operands from registers.
#pragma unroll
      for (int kk = 0; kk < QT / 2; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t gb[4], qb[4];
          load_b2_trans(gb, dt + (kk * 16) * LD + jp * 16, LD, lane);
          load_b2_trans(qb, qt + (kk * 16) * LD + jp * 16, LD, lane);
          mma_bf16(dv[2 * jp], pa, gb[0], gb[1]);
          mma_bf16(dv[2 * jp + 1], pa, gb[2], gb[3]);
          mma_bf16(dk[2 * jp], sa, qb[0], qb[1]);
          mma_bf16(dk[2 * jp + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk[0] + h * p.sdk[2] +
              (int64_t)k0 * p.sdk[1];
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv[0] + h * p.sdv[2] +
              (int64_t)k0 * p.sdv[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv0 + g + 8 * i;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t4;
      if (c < D) {
        *reinterpret_cast<uint32_t*>(dkg + r * p.sdk[1] + c) = pack_bf16(
            dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + r * p.sdv[1] + c) =
            pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
      }
    }
  }
}

// One launch of the dq (`dkv` false) or the dk/dv kernel at padded head
// dim DK.
template <int DK>
int launch_mma_dk(const Params& p, bool dkv, cudaStream_t stream) {
  const auto kernel = dkv ? rel_attention_bwd_dkv_mma_kernel<DK>
                          : rel_attention_bwd_dq_mma_kernel<DK>;
  const int rel = p.W + p.Hg;
  const size_t smem =
      dkv ? dkv_mma_smem_bytes(p.D, rel) : dq_mma_smem_bytes(p.D, rel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.L + kMmaRows - 1) / kMmaRows * p.B * p.H;
  kernel<<<blocks, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const Params& p, bool dkv, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_dk<16>(p, dkv, stream);
    case 2: return launch_mma_dk<32>(p, dkv, stream);
    case 3: return launch_mma_dk<48>(p, dkv, stream);
    case 4: return launch_mma_dk<64>(p, dkv, stream);
    case 5: return launch_mma_dk<80>(p, dkv, stream);
    case 6: return launch_mma_dk<96>(p, dkv, stream);
    case 7: return launch_mma_dk<112>(p, dkv, stream);
    case 8: return launch_mma_dk<128>(p, dkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The variant a launch takes: 1 = bf16 on the tensor cores, 0 = f32 on the
// CUDA cores; -1 for a dtype the kernels do not take.
int variant(int dtype) { return dtype == 1 ? 1 : dtype == 0 ? 0 : -1; }

bool valid(int dtype, int B, int H, int L, int D, int Hg, int W) {
  return B >= 1 && H >= 1 && Hg >= 1 && W >= 1 && L == Hg * W && D >= 8 &&
         D % 8 == 0 && D <= kMaxDim && (dtype == 0 || dtype == 1);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* rw, const float* rh,
                   const float* lse, const float* delta, int B, int H, int L,
                   int D, int Hg, int W, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.rw = rw;
  p.rh = rh;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.drw = p.drh = nullptr;
  p.B = B;
  p.H = H;
  p.L = L;
  p.D = D;
  p.Hg = Hg;
  p.W = W;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of each kernel needs at head dim d and
// rel = W + Hg for inputs of `itemsize` bytes (4: the f32 variant, 2: the
// bf16 one); the Python eligibility rule mirrors both.
size_t sav_rel_attention_bwd_dq_smem_bytes(int d, int rel, int itemsize) {
  return itemsize == 2 ? dq_mma_smem_bytes(d, rel) : dq_smem_bytes(d, rel);
}
size_t sav_rel_attention_bwd_dkv_smem_bytes(int d, int rel, int itemsize) {
  return itemsize == 2 ? dkv_mma_smem_bytes(d, rel) : dkv_smem_bytes(d, rel);
}

// dtype 0 = float32 -> 0 (CUDA cores), 1 = bfloat16 -> 1 (tensor cores),
// for both kernels.
int sav_rel_attention_bwd_variant(int dtype) { return variant(dtype); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, in order
// q, k, v, dO, dq, each (b, l, h). rw, rh, d_rw, d_rh: contiguous f32
// [B, H, L, W] / [B, H, L, Hg]; lse, delta: f32 [B, H, L].
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_rel_attention_bwd_dq(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const float* rw,
                             const float* rh, const float* lse,
                             const float* delta, void* dq, float* drw,
                             float* drh, int B, int H, int L, int D, int Hg,
                             int W, const int64_t* strides, float scale,
                             void* stream) {
  if (!valid(dtype, B, H, L, D, Hg, W)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, rw, rh, lse, delta, B, H, L, D, Hg, W,
                         scale);
  p.dq = dq;
  p.drw = drw;
  p.drh = drh;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sdo[i] = strides[9 + i];
    p.sdq[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant(dtype) == 1 ? launch_mma(p, false, s)
                             : launch_f32(p, false, s);
}

// strides: 18 element strides, in order q, k, v, dO, dk, dv, each (b, l, h).
int sav_rel_attention_bwd_dkv(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* rw, const float* rh,
                              const float* lse, const float* delta, void* dk,
                              void* dv, int B, int H, int L, int D, int Hg,
                              int W, const int64_t* strides, float scale,
                              void* stream) {
  if (!valid(dtype, B, H, L, D, Hg, W)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, rw, rh, lse, delta, B, H, L, D, Hg, W,
                         scale);
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sdo[i] = strides[9 + i];
    p.sdk[i] = strides[12 + i];
    p.sdv[i] = strides[15 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant(dtype) == 1 ? launch_mma(p, true, s)
                             : launch_f32(p, true, s);
}

}  // extern "C"
