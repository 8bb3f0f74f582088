// Blocked (flash) attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (sav_tpu/ops/flash_attention.py
// :360, pallas_call at :468) and `_bwd_dkv_kernel` (:405, pallas_call at
// :492), host side `_flash_backward_pallas` (:446). Both recompute the
// probabilities tile by tile from the forward's f32 lse, with
// delta = sum_d dO * O formed before them (one PyTorch reduction, as
// sav_tpu's `_bwd_prep` forms it outside its kernels):
//
//   s  = (q . k) * scale          f32 product, THEN the scale (as the forward)
//   p  = exp(s - lse)             zero on rows past Lq (and columns past Lk)
//   dp = dO . v                   f32
//   ds = p * (dp - delta)
//   dq = sum over kv of (ds -> k dtype) . k * scale          (dq kernel)
//   dv = sum over q of (p -> dO dtype)^T dO                  (dk/dv kernel)
//   dk = sum over q of (ds -> q dtype)^T q * scale           (dk/dv kernel)
//
// The roundings to the input dtype sit where the TPU kernels cast before
// each product, so bf16 gradients round as sav_tpu's do.
//
// What bounds them on the H100: at the ViT-B/16 384² train shape (B=128,
// L=577, H=12, D=64, bf16) dq moves ~574 MB (q, k, v, dO, lse, delta in; dq
// out) and does three products, ~196 GFLOP; dk/dv moves ~688 MB and does
// four, ~262 GFLOP. Both floors are operations on the tensor cores, ~0.20
// and ~0.27 ms.
//
// Two variants of each, chosen by the C entry points by dtype
// (`sav_flash_attention_bwd_variant`), each launch counted once:
//
// - bf16: tensor cores (`flash_attention_bwd_dq_mma_kernel`,
//   `flash_attention_bwd_dkv_mma_kernel`). Every product is warp-level
//   mma.sync.m16n8k16 (bf16 operands, f32 accumulators; mma_tiles.cuh),
//   each warp owning 16 rows, 4 warps a block. Head dims are zero-padded
//   to the MMA depth (16) in shared memory, and padded rows and columns
//   add exact zeros; p is still forced to 0 past Lk (dq) and past Lq
//   (dk/dv). The exponential is one ex2 per score, the scale and the lse
//   folded into base 2.
//   - dq: one block per (slice, 64 q rows), the q tiles of a slice
//     adjacent in the grid so its K/V come from L2 after their first
//     read. K and V stream in 64-row tiles through a two-stage cp.async
//     ring. Per tile a warp forms S = Q.K^T and dP = dO.V^T from the same
//     B-fragment loop, then P = ex2(S*scale*log2e - lse*log2e) and
//     dS = P (dP - delta) in registers (each thread's two rows keep their
//     lse and delta for the whole sweep), and adds (dS -> bf16).K to the
//     f32 dQ accumulators, the A operand straight from the dS accumulators
//     (no shared memory).
//   - dk/dv: one block per (slice, 64 kv rows), the dK/dV half of the
//     fused backward's tensor-core kernel. q, dO, lse and delta stream in
//     64-row tiles through a two-stage cp.async ring; per tile a warp forms
//     S^T = K.Q^T and dP^T = V.dO^T for its kv rows, then P^T and dS^T,
//     and adds (P^T -> bf16).dO to dV and (dS^T -> bf16).Q to dK, both f32
//     in registers for the whole sweep, A operands from the accumulators.
//     Up to head dim 64 the warp's K and V fragments stay in registers.
//   Launch bounds keep 3 blocks (12 warps) an SM up to head dim 64, 2
//   above: fewer warps an SM, or 128-row blocks of 8 warps, ran markedly
//   slower on the H100, so latency, not the products, bounds both (they
//   reach about a fifth of the tensor cores' bf16 peak); wgmma with TMA and
//   producer/consumer warps is the next step.
// - f32: CUDA cores (`flash_attention_bwd_dq_kernel`,
//   `flash_attention_bwd_dkv_kernel`), exact f32 products, no TF32: the
//   f32 checks hold 2e-5. Tile pieces in flash_tiles.cuh:
//   - dq: one block per (batch*head slice, 64-row q tile) loops over the
//     kv tiles (the TPU's kv-innermost grid); q and dO stay in shared
//     memory, k and v stream through it, dq accumulates in registers.
//   - dk/dv: one block per (batch*head slice, 64-row kv tile) loops over
//     the q tiles (the TPU's q-innermost grid); k and v stay, q, dO, lse
//     and delta stream, dk and dv accumulate in registers. The block
//     computes the transposed scores (kv rows by q columns), so p and ds
//     land in shared memory already in the layout the dv and dk products
//     read.
//
// Both: every output element has one owner, summed in a fixed order: no
// atomics, and the same bits on every run (remat recomputes rely on it).
// q/k/v/dO are read strided in their [B, L, H, D] layout (unit stride on
// D, 16-byte aligned rows) and dq/dk/dv written the same way.

#include <math.h>

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Lq], contiguous
  const float* delta;  // [B, H, Lq], contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};

// ---- f32 on the CUDA cores ----

// Dynamic shared memory of one f32 block. dq: f32 q, dO, k and v tiles and
// the ds tile. dk/dv: f32 k, v, q and dO tiles, the p and ds tiles, and the
// q tile's lse and delta.
__host__ __device__ inline size_t dq_smem_bytes(int d) {
  return 4 * tile_bytes(d) + score_bytes();
}
__host__ __device__ inline size_t dkv_smem_bytes(int d) {
  return 4 * tile_bytes(d) + 2 * score_bytes() + 2 * kTile * sizeof(float);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  float* qs = smem;
  float* dos = qs + kTile * tile_ld(D);
  float* ks = dos + kTile * tile_ld(D);
  float* vs = ks + kTile * tile_ld(D);
  float* dss = vs + kTile * tile_ld(D);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int nq = min(kTile, p.Lq - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

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

  float lse[4], delta[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const size_t row = (size_t)bh * p.Lq + q0 + r;
    lse[i] = r < nq ? p.lse[row] : 0.f;
    delta[i] = r < nq ? p.delta[row] : 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.Lk; k0 += kTile) {
    const int nk = min(kTile, p.Lk - k0);
    __syncthreads();  // the previous tile's k and ds are no longer read
    load_tile<T>(ks, kg + (int64_t)k0 * p.sk[1], p.sk[1], nk, D);
    load_tile<T>(vs, vg + (int64_t)k0 * p.sv[1], p.sv[1], nk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(qs, ks, D, ty, tx, s);
    tile_dot(dos, vs, D, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pr =
            (r < nq && c < nk) ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        dss[r * kLdS + c] = Elem<T>::round(pr * (dp[i][j] - delta[i]));
      }
    }
    __syncthreads();  // every thread's ds is in place
    tile_pv<NU>(dss, ks, D, ty, tx, acc);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[2] +
           (int64_t)q0 * p.sdq[1];
  store_tile<T, NU>(dqg, p.sdq[1], nq, D, ty, tx, acc, p.scale);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  float* ks = smem;
  float* vs = ks + kTile * tile_ld(D);
  float* qs = vs + kTile * tile_ld(D);
  float* dos = qs + kTile * tile_ld(D);
  float* pts = dos + kTile * tile_ld(D);
  float* dsts = pts + kTile * kLdS;
  float* lse_s = dsts + kTile * kLdS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kTile;
  const int nk = min(kTile, p.Lk - k0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  const float* lseg = p.lse + (size_t)bh * p.Lq;
  const float* deltag = p.delta + (size_t)bh * p.Lq;
  load_tile<T>(ks,
               static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2] +
                   (int64_t)k0 * p.sk[1],
               p.sk[1], nk, D);
  load_tile<T>(vs,
               static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2] +
                   (int64_t)k0 * p.sv[1],
               p.sv[1], nk, D);

  float4 adk[4][NU], adv[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      adk[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      adv[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int q0 = 0; q0 < p.Lq; q0 += kTile) {
    const int nq = min(kTile, p.Lq - q0);
    __syncthreads();  // the previous tile's q, dO, p and ds are no longer read
    load_tile<T>(qs, qg + (int64_t)q0 * p.sq[1], p.sq[1], nq, D);
    load_tile<T>(dos, dog + (int64_t)q0 * p.sdo[1], p.sdo[1], nq, D);
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
        const float pr = r < nq ? expf(st[i][j] * p.scale - lse_s[r]) : 0.f;
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
  const size_t smem = dq_smem_bytes(p.D);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lq + kTile - 1) / kTile);
  flash_attention_bwd_dq_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NU>
int launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lk + kTile - 1) / kTile);
  flash_attention_bwd_dkv_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
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

constexpr int kMmaRows = 64;                 // q rows (dq), kv rows (dk/dv)
constexpr int kMmaWarps = kMmaRows / 16;     // 16 rows a warp
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaQTile = 64;                // q rows a dk/dv tile streams

// Dynamic shared memory of one bf16 block at head dim d, bf16 rows of
// round_up16(d) + 8. dq: the block's q and dO rows and two stages of k and
// v tiles (kTile rows). dk/dv: the block's k and v rows, two stages of q
// and dO tiles, and the two stages' f32 lse and delta.
__host__ __device__ inline size_t dq_mma_smem_bytes(int d) {
  return (size_t)(2 * kMmaRows + 4 * kTile) * (round_up16(d) + 8) *
         sizeof(bf16);
}
__host__ __device__ inline size_t dkv_mma_smem_bytes(int d) {
  return (size_t)(2 * kMmaRows + 4 * kMmaQTile) * (round_up16(d) + 8) *
             sizeof(bf16) +
         4 * kMmaQTile * sizeof(float);
}

template <int DK>
__global__ void __launch_bounds__(kMmaThreads, DK <= 64 ? 3 : 2)
    flash_attention_bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = DK + 8;      // bf16 row stride of every tile
  constexpr int NT = DK / 8;      // 8-column tiles of dQ
  constexpr int KS = DK / 16;     // k-steps of S and dP
  constexpr int ST = kTile / 8;   // 8-column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kMmaRows * LD;
  bf16* ks = dos + kMmaRows * LD;  // [2][kTile][LD]
  bf16* vs = ks + 2 * kTile * LD;  // [2][kTile][LD]

  const int D = p.D;
  const int qtiles = (p.Lq + kMmaRows - 1) / kMmaRows;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kMmaRows;
  const int nq = min(kMmaRows, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the block
  const bool active = wrow < nq;

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const int ntiles = (p.Lk + kTile - 1) / kTile;
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
  load_tile_async<kMmaThreads>(ks, LD, kg, p.sk[1], kTile, min(kTile, p.Lk),
                               DK, D);
  load_tile_async<kMmaThreads>(vs, LD, vg, p.sv[1], kTile, min(kTile, p.Lk),
                               DK, D);
  cp_async_commit();

  // The lse (base 2) and delta of the thread's rows g and g + 8, for the
  // whole sweep.
  const float scale2 = p.scale * kLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    const size_t row = (size_t)bh * p.Lq + q0 + r;
    lse2[i] = r < nq ? p.lse[row] * kLog2e : 0.f;
    delta[i] = r < nq ? p.delta[row] : 0.f;
  }

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = (t + 1) * kTile;
      const int n1 = min(kTile, p.Lk - k1);
      load_tile_async<kMmaThreads>(ks + (stage ^ 1) * kTile * LD, LD,
                                   kg + (int64_t)k1 * p.sk[1], p.sk[1], kTile,
                                   n1, DK, D);
      load_tile_async<kMmaThreads>(vs + (stage ^ 1) * kTile * LD, LD,
                                   vg + (int64_t)k1 * p.sv[1], p.sv[1], kTile,
                                   n1, DK, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if (active) {
      const bf16* kt = ks + stage * kTile * LD;
      const bf16* vt = vs + stage * kTile * LD;
      const int nk = min(kTile, p.Lk - t * kTile);

      // S = Q.K^T and dP = dO.V^T for the warp's 16 rows and the tile's
      // 64 columns; the Q and dO fragments are re-read from shared memory
      // every tile (held in registers they cause spills at head dim 64 and
      // save no time).
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        load_a(qa, qs + wrow * LD + kk * 16, LD, lane);
        load_a(da, dos + wrow * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < ST / 2; ++jp) {
          uint32_t kb[4], vb[4];
          load_b2(kb, kt + (jp * 16) * LD + kk * 16, LD, lane);
          load_b2(vb, vt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * jp], da, vb[0], vb[1]);
          mma_bf16(dp[2 * jp + 1], da, vb[2], vb[3]);
        }
      }

      // P = exp(s * scale - lse) by one ex2, 0 on columns past Lk (last
      // tile only); dS = P (dP - delta), in f32, into s.
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pr = exp2_approx(fmaf(s[j][e], scale2, -lse2[i]));
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
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
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

template <int DK>
__global__ void __launch_bounds__(kMmaThreads, DK <= 64 ? 3 : 2)
    flash_attention_bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = DK + 8;           // bf16 row stride of every tile
  constexpr int NT = DK / 8;           // 8-column tiles of dK and dV
  constexpr int KS = DK / 16;          // k-steps of S^T and dP^T
  constexpr int QT = kMmaQTile / 8;    // 8-column tiles of a q tile
  constexpr bool kHold = DK <= 64;     // K and V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kMmaRows * LD;
  bf16* qts = vs + kMmaRows * LD;           // [2][kMmaQTile][LD]
  bf16* dots = qts + 2 * kMmaQTile * LD;    // [2][kMmaQTile][LD]
  // [2][2][kMmaQTile]: per stage the tile's lse, then its delta.
  float* rows_s = reinterpret_cast<float*>(dots + 2 * kMmaQTile * LD);

  const int D = p.D;
  const int Lq = p.Lq;
  const int kvtiles = (p.Lk + kMmaRows - 1) / kMmaRows;
  const int bh = blockIdx.x / kvtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = (blockIdx.x - bh * kvtiles) * kMmaRows;
  const int nk = min(kMmaRows, p.Lk - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv0 = warp * 16;  // the warp's first kv row in the block
  const bool active = kv0 < nk;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  const float* lseg = p.lse + (size_t)bh * Lq;
  const float* deltag = p.delta + (size_t)bh * Lq;
  const int ntq = (Lq + kMmaQTile - 1) / kMmaQTile;

  // q, dO, lse and delta of q tile `t` into `stage`, zero past Lq.
  auto load_q_tile = [&](int t, int stage) {
    const int q0 = t * kMmaQTile;
    const int n = min(kMmaQTile, Lq - q0);
    load_tile_async<kMmaThreads>(qts + stage * kMmaQTile * LD, LD,
                                 qg + (int64_t)q0 * p.sq[1], p.sq[1],
                                 kMmaQTile, n, DK, D);
    load_tile_async<kMmaThreads>(dots + stage * kMmaQTile * LD, LD,
                                 dog + (int64_t)q0 * p.sdo[1], p.sdo[1],
                                 kMmaQTile, n, DK, D);
    for (int i = threadIdx.x; i < 2 * kMmaQTile; i += kMmaThreads) {
      const int r = i < kMmaQTile ? i : i - kMmaQTile;
      const float* src = (i < kMmaQTile ? lseg : deltag) + q0 + r;
      cp_async4(rows_s + stage * 2 * kMmaQTile + i, r < n ? src : lseg,
                r < n);
    }
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
      const int nq = min(kMmaQTile, Lq - t * kMmaQTile);

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

      // P^T = exp(s * scale - lse) by one ex2, 0 on q columns past Lq
      // (last tile only), and dS^T = P^T (dP^T - delta), in f32.
#pragma unroll
      for (int j = 0; j < QT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t4 + (e & 1);
          float pr = exp2_approx(fmaf(st[j][e], scale2, -lse_s[c] * kLog2e));
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
  const auto kernel = dkv ? flash_attention_bwd_dkv_mma_kernel<DK>
                          : flash_attention_bwd_dq_mma_kernel<DK>;
  const size_t smem = dkv ? dkv_mma_smem_bytes(p.D) : dq_mma_smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = dkv ? p.Lk : p.Lq;
  const int blocks = (rows + kMmaRows - 1) / kMmaRows * p.B * p.H;
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

bool valid(int dtype, int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && D >= 8 && D % 8 == 0 &&
         D <= kMaxDim && (dtype == 0 || dtype == 1);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   int B, int H, int Lq, int Lk, int D, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of each kernel needs at head dim d for
// inputs of `itemsize` bytes (4: the f32 variant, 2: the bf16 one); the
// Python eligibility rule mirrors both.
size_t sav_flash_attention_bwd_dq_smem_bytes(int d, int itemsize) {
  return itemsize == 2 ? dq_mma_smem_bytes(d) : dq_smem_bytes(d);
}
size_t sav_flash_attention_bwd_dkv_smem_bytes(int d, int itemsize) {
  return itemsize == 2 ? dkv_mma_smem_bytes(d) : dkv_smem_bytes(d);
}

// dtype 0 = float32 -> 0 (CUDA cores), 1 = bfloat16 -> 1 (tensor cores),
// for both kernels.
int sav_flash_attention_bwd_variant(int dtype) { return variant(dtype); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, in order
// q, k, v, dO, dq, each (b, l, h). lse, delta: [B, H, Lq] f32.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               int B, int H, int Lq, int Lk, int D,
                               const int64_t* strides, float scale,
                               void* stream) {
  if (!valid(dtype, B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Lq, Lk, D, scale);
  p.dq = dq;
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
int sav_flash_attention_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, int B, int H, int Lq,
                                int Lk, int D, const int64_t* strides,
                                float scale, void* stream) {
  if (!valid(dtype, B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Lq, Lk, D, scale);
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
