// Single-pass fused attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in sav_tpu/ops/fused_attention.py
// (driver `_fused_forward`, pallas_call at :334). Like it, one pass over the
// whole kv row: s = (q . k) accumulated in f32, THEN * scale, plus an optional
// f32 bias, a plain full-row softmax (row max, exp, sum), o = (p in the value
// dtype . v) / l accumulated in f32, and optionally lse = m + log l. The
// [B, H, Lq, Lk] scores and probabilities never reach device memory.
//
// What bounds it on the H100: at the DeiT-S train shape (B=256, L=197, H=6,
// D=64, bf16, with the lse) the function moves ~156 MB (q, k, v, o and the
// lse once each) and does ~15 GFLOP, so the card's floor is memory: ~0.047
// ms at 3.35 TB/s (~5.8 us at the serve shape, B=32).
//
// Two variants, chosen by the C entry point by dtype and head dim
// (`sav_fused_attention_variant`), both counted as one launch of this
// kernel:
//
// - bf16 at D <= 128: tensor cores (`fused_attention_fwd_mma_kernel`).
//   Both products are warp-level mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators; mma_tiles.cuh). One block per (batch*head slice, tile of
//   128 query rows; 64 above head dim 64), the tiles of a slice adjacent in
//   the grid. The block copies the slice's whole K and V into bf16 shared
//   tiles once (rows padded to 16 and zero-filled, head dims to the MMA
//   depth of 16), in cp.async commit groups: the q tile lands first, in
//   V's space, and each warp loads its q fragments into registers from
//   there; then V is copied over it while the first sweep runs on K. Each
//   warp owns 32 query rows (two 16-row m-tiles, so every K/V fragment read
//   from shared memory feeds two products) up to head dim 64, 16 above.
//   Two sweeps over the kv row keep the reference's cast point: the first
//   forms S = Q.K^T in 64-column steps and takes the exact row max (quad
//   shuffles); the second forms each 32-column step of S again (the same
//   products, so the same bits), takes p = 2^((s - m) log2 e) with one SFU
//   ex2 a score, sums the unrounded f32 p into l, and packs p to bf16
//   straight from the accumulators as the A operand of P.V (V fragments by
//   ldmatrix.trans). As m is final before any p is formed, no rescale by
//   alpha is needed and p is rounded after the full-row max, as the
//   reference rounds it (an online softmax rounds p per tile and gives
//   other bits). o = acc / l last. The scale folds into the ex2's argument
//   where there is no bias; with a bias, the scores are scaled and biased
//   in base 2 first. Not bound by the bytes: Q.K^T runs twice (a third more
//   products than an online softmax), and three 4-warp blocks per SM do
//   not hide the latency of the dependent copy, product and exp steps;
//   wgmma with TMA is the next step.
// - f32, and bf16 at D > 128: CUDA cores (`fused_attention_fwd_kernel`),
//   exact f32 products (no TF32: the f32 checks hold 2e-5). The block
//   copies the slice's whole K and V into dynamic shared memory with
//   16-byte loads (K rows padded by 16 bytes so that lanes reading different
//   K rows hit different banks); each warp carries kRows query rows at a
//   time, lanes striding over the kv columns and reusing each K chunk for
//   the warp's rows; warp shuffles give the row max and the row sum; the
//   rounded p goes through a shared f32 row to PV, where each lane owns
//   pairs of output columns and sweeps all kv rows. Bound by issued FMA and
//   shared-memory instructions.
//
// Both: q/k/v/o are read and written strided in their [B, L, H, D] layout
// (unit stride on D), so the caller makes no transposed or padded copies;
// ragged edges (rows past Lq, columns past Lk) are masked by bounds. The
// bias is read through four strides (batch, head, q, k); a broadcast axis
// has stride 0, so (1,1), (1,H), (B,1) and (B,H) biases are never
// materialised to [B, H, Lq, Lk].

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // query rows a warp carries at once
constexpr int kBlockQ = 64;               // query rows per block
constexpr int kMaxDim = 256;              // largest head dim
constexpr int kMaxPairs = kMaxDim / 64;   // output column pairs per lane

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // may be null
  void* o;
  float* lse;  // [B, H, Lq], may be null
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3];
  // Bias strides of the batch, head, q and k axes (0 on a broadcast axis).
  int64_t sb[4];
  float scale;
};

// Dynamic shared memory of one block: K (rows padded by 16 bytes), V, and
// per warp kRows f32 query rows and kRows f32 probability rows.
__host__ __device__ inline size_t smem_bytes(int lk, int d, int itemsize) {
  const int vec = 16 / itemsize;
  return (size_t)lk * (2 * d + vec) * itemsize +
         (size_t)kWarps * kRows * (d + round_up4(lk)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lk = p.Lk;
  const int chunks = D / V;  // 16-byte chunks per row
  const int kstride = D + V;  // padded K row, in elements
  const int pstride = round_up4(Lk);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Lk * kstride;
  float* qs = reinterpret_cast<float*>(vs + (size_t)Lk * D);
  float* ps = qs + kWarps * kRows * D;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q_begin = blockIdx.y * kBlockQ;
  const int q_end = min(q_begin + kBlockQ, p.Lq);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. The slice's whole K and V into shared memory.
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  for (int i = tid; i < Lk * chunks; i += kThreads) {
    const int j = i / chunks;
    const int c = i - j * chunks;
    const uint4 kk = *reinterpret_cast<const uint4*>(kg + j * p.sk[1] + c * V);
    const uint4 vv = *reinterpret_cast<const uint4*>(vg + j * p.sv[1] + c * V);
    *reinterpret_cast<uint4*>(ks + (size_t)j * kstride + c * V) = kk;
    *reinterpret_cast<uint4*>(vs + (size_t)j * D + c * V) = vv;
  }
  __syncthreads();

  float* qw = qs + warp * kRows * D;
  float* pw = ps + warp * kRows * pstride;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];
  const float* bg =
      p.bias != nullptr ? p.bias + b * p.sb[0] + h * p.sb[1] : nullptr;

  for (int row0 = q_begin + warp * kRows; row0 < q_end;
       row0 += kWarps * kRows) {
    const int nrows = min(kRows, q_end - row0);

    // 2. The warp's query rows, widened to f32; rows past the end are zero.
    for (int i = lane; i < kRows * D; i += 32) {
      const int r = i / D;
      const int d = i - r * D;
      qw[i] = r < nrows ? E::load(qg + (row0 + r) * p.sq[1] + d) : 0.f;
    }
    __syncwarp();

    // 3. s = (q . k) * scale + bias, lanes striding over the kv columns.
    float m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* krow = ks + (size_t)j * kstride;
      for (int c = 0; c < chunks; ++c) {
        float kf[V];
        E::unpack(*reinterpret_cast<const uint4*>(krow + c * V), kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(qw + r * D + c * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 x = qv[e];
            acc[r] = fmaf(x.x, kf[4 * e], acc[r]);
            acc[r] = fmaf(x.y, kf[4 * e + 1], acc[r]);
            acc[r] = fmaf(x.z, kf[4 * e + 2], acc[r]);
            acc[r] = fmaf(x.w, kf[4 * e + 3], acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s = acc[r] * p.scale;
        if (bg != nullptr && r < nrows)
          s += bg[(row0 + r) * p.sb[2] + j * p.sb[3]];
        pw[r * pstride + j] = s;
        m[r] = fmaxf(m[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = warp_max(m[r]);

    // 4. p = exp(s - m) in place (rounded to the value dtype), l = sum of the
    //    unrounded p. Each lane touches only its own columns here.
    float l[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] = 0.f;
    for (int j = lane; j < Lk; j += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = expf(pw[r * pstride + j] - m[r]);
        l[r] += e;
        pw[r * pstride + j] = E::round(e);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] = warp_sum(l[r]);
    __syncwarp();  // PV reads every lane's p

    // 5. o = (p . v) / l; lane owns the column pairs d = 2 * lane + 64 * u.
    float2 o[kRows][kMaxPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) o[r][u] = make_float2(0.f, 0.f);
    int j = 0;
    for (; j + 4 <= Lk; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(pw + r * pstride + j);
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 v0 = E::load2(vs + (size_t)(j + 0) * D + d);
          const float2 v1 = E::load2(vs + (size_t)(j + 1) * D + d);
          const float2 v2 = E::load2(vs + (size_t)(j + 2) * D + d);
          const float2 v3 = E::load2(vs + (size_t)(j + 3) * D + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float2 a = o[r][u];
            a.x = fmaf(pr[r].x, v0.x, a.x);
            a.y = fmaf(pr[r].x, v0.y, a.y);
            a.x = fmaf(pr[r].y, v1.x, a.x);
            a.y = fmaf(pr[r].y, v1.y, a.y);
            a.x = fmaf(pr[r].z, v2.x, a.x);
            a.y = fmaf(pr[r].z, v2.y, a.y);
            a.x = fmaf(pr[r].w, v3.x, a.x);
            a.y = fmaf(pr[r].w, v3.y, a.y);
            o[r][u] = a;
          }
        }
      }
    }
    for (; j < Lk; ++j) {
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 vv = E::load2(vs + (size_t)j * D + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pj = pw[r * pstride + j];
            o[r][u].x = fmaf(pj, vv.x, o[r][u].x);
            o[r][u].y = fmaf(pj, vv.y, o[r][u].y);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        T* orow = og + (row0 + r) * p.so[1];
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            E::store(orow + d, o[r][u].x / l[r]);
            E::store(orow + d + 1, o[r][u].y / l[r]);
          }
        }
        if (p.lse != nullptr && lane == 0)
          p.lse[(size_t)bh * p.Lq + row0 + r] = m[r] + logf(l[r]);
      }
    }
    __syncwarp();  // the next row group overwrites qw and pw
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, p.D, (int)sizeof(T));
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lq + kBlockQ - 1) / kBlockQ);
  fused_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

constexpr int kMmaMaxDim = 128;  // largest head dim of the bf16 variant
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kSweep1Cols = 64;  // kv columns per step of the max sweep
constexpr int kSweep2Cols = 32;  // kv columns per step of the exp / P.V sweep

// 16-row m-tiles a warp owns: two up to head dim 64 (each K/V fragment
// feeds two products), one above, where two would not fit the registers
// beside the q fragments and the output accumulators.
__host__ __device__ constexpr int mma_tiles(int dk) { return dk <= 64 ? 2 : 1; }

// Query rows of one bf16 block at head dim d: 128 up to 64, 64 above.
__host__ __device__ inline int mma_rows(int d) {
  return 16 * kMmaWarps * mma_tiles(round_up16(d));
}

// Dynamic shared memory of one bf16 block: the slice's K and V, each
// round_up16(lk) bf16 rows of round_up16(d) + 8; the q tile lands in V's
// space first, so that space holds at least the block's q rows.
__host__ __device__ inline size_t mma_smem_bytes(int lk, int d) {
  const int rows = round_up16(lk);
  const int vrows = rows > mma_rows(d) ? rows : mma_rows(d);
  return (size_t)(rows + vrows) * (round_up16(d) + 8) * sizeof(bf16);
}

// The scores of 8-column tiles in accumulator layout, the same arithmetic in
// both sweeps: with `prescaled`, the scaled product plus the bias in base 2;
// without, the raw product; -inf from column `lk` on (columns past the
// slice, and the zero rows that pad K to 16). c0: the first tile's column;
// r0: the row of elements 0 and 1 (2 and 3 sit 8 rows below).
template <int NJ>
__device__ __forceinline__ void finish_scores(float s[NJ][4], int c0, int r0,
                                              int t4, int lk, int nq,
                                              bool prescaled, float scale2,
                                              const float* bg,
                                              const Params& p) {
  if (prescaled) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + j * 8 + 2 * t4 + (e & 1);
        const int r = r0 + 8 * (e >> 1);
        s[j][e] *= scale2;
        if (bg != nullptr && r < nq && c < lk)
          s[j][e] = fmaf(bg[r * p.sb[2] + (int64_t)c * p.sb[3]], kLog2e,
                         s[j][e]);
      }
    }
  }
  if (c0 + NJ * 8 > lk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + j * 8 + 2 * t4 + (e & 1) >= lk) s[j][e] = -INFINITY;
  }
}

// s[mt][j] = Q . K^T for the warp's m-tiles and the NJ 8-column tiles from
// kv row c0, K fragments by ldmatrix; tiles at or past `rows` (the padded K
// rows) are left 0.
template <int MT, int KS, int NJ, int LD>
__device__ __forceinline__ void qk_step(float s[MT][NJ][4],
                                        const uint32_t qf[MT][KS][4],
                                        const bf16* ks, int c0, int rows,
                                        int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      if (c0 + 16 * jp < rows) {
        uint32_t kb[4];
        load_b2(kb, ks + (c0 + 16 * jp) * LD + kk * 16, LD, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jp], qf[mt][kk], kb[0], kb[1]);
          mma_bf16(s[mt][2 * jp + 1], qf[mt][kk], kb[2], kb[3]);
        }
      }
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kMmaThreads, 3)
    fused_attention_fwd_mma_kernel(const Params p) {
  constexpr int MT = mma_tiles(DK);
  constexpr int kRowsBlk = 16 * kMmaWarps * MT;
  constexpr int LD = DK + 8;   // bf16 row stride of the K and V tiles
  constexpr int NT = DK / 8;   // 8-column tiles of the output
  constexpr int KS = DK / 16;  // k-steps of Q.K^T
  constexpr int N1 = kSweep1Cols / 8;
  constexpr int N2 = kSweep2Cols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int Lk = p.Lk;
  const int rows = round_up16(Lk);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + rows * LD;  // the q tile first, then V

  const int qtiles = (p.Lq + kRowsBlk - 1) / kRowsBlk;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kRowsBlk;
  const int nq = min(kRowsBlk, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16 * MT;  // the warp's first row in the q tile
  const bool active = wrow < nq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] +
                   h * p.sq[2] + (int64_t)q0 * p.sq[1];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* bg = p.bias != nullptr
                        ? p.bias + b * p.sb[0] + h * p.sb[1] +
                              (int64_t)q0 * p.sb[2]
                        : nullptr;

  // 1. The q tile into V's space (first group), K (second group); the q
  //    fragments into registers; then V over the q tile (third group).
  load_tile_async<kMmaThreads>(vs, LD, qg, p.sq[1], kRowsBlk, nq, DK, D);
  cp_async_commit();
  load_tile_async<kMmaThreads>(ks, LD, kg, p.sk[1], rows, Lk, DK, D);
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (active)
        load_a(qf[mt][kk], vs + (wrow + 16 * mt) * LD + kk * 16, LD, lane);
      else
        qf[mt][kk][0] = qf[mt][kk][1] = qf[mt][kk][2] = qf[mt][kk][3] = 0u;
    }
  __syncthreads();  // every warp holds its q fragments: V may land there
  load_tile_async<kMmaThreads>(vs, LD, vg, p.sv[1], rows, Lk, DK, D);
  cp_async_commit();
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // Without a bias and at a positive scale, the max of the raw products is
  // the max of the scaled scores, and the scale folds into the ex2's
  // argument (`unit`); otherwise the scores are scaled and biased in base 2
  // first (`prescaled`, unit 1).
  const float scale2 = p.scale * kLog2e;
  const bool prescaled = p.bias != nullptr || !(p.scale > 0.f);
  const float unit = prescaled ? 1.f : scale2;

  // 2. The exact row max: rows g and g + 8 of each m-tile (index 2mt + i).
  float m[2 * MT];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) m[i] = -INFINITY;
  if (active) {
    for (int c0 = 0; c0 < rows; c0 += kSweep1Cols) {
      float s[MT][N1][4];
      qk_step<MT, KS, N1, LD>(s, qf, ks, c0, rows, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        finish_scores<N1>(s[mt], c0, wrow + 16 * mt + g, t4, Lk, nq,
                          prescaled, scale2, bg, p);
#pragma unroll
        for (int j = 0; j < N1; ++j) {
          m[2 * mt] = fmaxf(m[2 * mt], fmaxf(s[mt][j][0], s[mt][j][1]));
          m[2 * mt + 1] = fmaxf(m[2 * mt + 1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) m[i] = quad_max(m[i]);

  cp_async_wait<0>();
  __syncthreads();  // V has landed
  if (!active) return;

  // 3. p = 2^(s·unit - m·unit) from the same scores, l = sum of the f32 p,
  //    O += (p -> bf16) . V.
  float mu[2 * MT], l[2 * MT];
  float o[MT][NT][4];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    mu[i] = m[i] * unit;
    l[i] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;

  for (int c0 = 0; c0 < rows; c0 += kSweep2Cols) {
    float s[MT][N2][4];
    qk_step<MT, KS, N2, LD>(s, qf, ks, c0, rows, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      finish_scores<N2>(s[mt], c0, wrow + 16 * mt + g, t4, Lk, nq, prescaled,
                        scale2, bg, p);
#pragma unroll
      for (int j = 0; j < N2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e >> 1);
          const float x = exp2_approx(fmaf(s[mt][j][e], unit, -mu[i]));
          l[i] += x;
          s[mt][j][e] = x;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < N2 / 2; ++kk) {
      if (c0 + 16 * kk < rows) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t vb[4];
          load_b2_trans(vb, vs + (c0 + 16 * kk) * LD + jp * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * jp], pa[mt], vb[0], vb[1]);
            mma_bf16(o[mt][2 * jp + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    }
  }

  // 4. o = acc / l, cast; lse = m + log l in natural units.
  bf16* og = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[2] +
             (int64_t)q0 * p.so[1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lsum = quad_sum(l[2 * mt + i]);
      const int r = wrow + 16 * mt + g + 8 * i;
      if (r >= nq) continue;
      if (p.lse != nullptr && t4 == 0)
        p.lse[(size_t)bh * p.Lq + q0 + r] = mu[2 * mt + i] * kLn2 + logf(lsum);
      bf16* orow = og + r * p.so[1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t4;
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
              o[mt][j][2 * i] / lsum, o[mt][j][2 * i + 1] / lsum);
      }
    }
  }
}

template <int DK>
int launch_mma_dk(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.Lk, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_mma_kernel<DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = mma_rows(p.D);
  const int blocks = (p.Lq + rows - 1) / rows * p.B * p.H;
  fused_attention_fwd_mma_kernel<DK><<<blocks, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const Params& p, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_dk<16>(p, stream);
    case 2: return launch_mma_dk<32>(p, stream);
    case 3: return launch_mma_dk<48>(p, stream);
    case 4: return launch_mma_dk<64>(p, stream);
    case 5: return launch_mma_dk<80>(p, stream);
    case 6: return launch_mma_dk<96>(p, stream);
    case 7: return launch_mma_dk<112>(p, stream);
    case 8: return launch_mma_dk<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The variant a launch takes: 1 = tensor cores (bf16, D <= 128), 0 = CUDA
// cores (f32, and bf16 above 128); -1 for a dtype the kernel does not take.
int variant(int dtype, int d) {
  if (dtype == 1) return d <= kMmaMaxDim ? 1 : 0;
  return dtype == 0 ? 0 : -1;
}

// Shared-memory bytes of one block of the variant that takes the shape.
size_t variant_smem_bytes(int lk, int d, int itemsize) {
  return variant(itemsize == 2 ? 1 : 0, d) == 1 ? mma_smem_bytes(lk, d)
                                                : smem_bytes(lk, d, itemsize);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the variant that takes the shape needs
// (itemsize 2: bf16, 4: f32); the Python eligibility rule mirrors it.
size_t sav_fused_attention_smem_bytes(int lk, int d, int itemsize) {
  return variant_smem_bytes(lk, d, itemsize);
}

// dtype 0 = float32 -> 0 (CUDA cores); 1 = bfloat16 -> 1 (tensor cores) up
// to head dim 128, 0 above.
int sav_fused_attention_variant(int dtype, int d) { return variant(dtype, d); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, in order
// q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), bias (b, h, q, k).
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_fused_attention_fwd(int dtype, const void* q, const void* k,
                            const void* v, const float* bias, void* o,
                            float* lse, int B, int H, int Lq, int Lk, int D,
                            const int64_t* strides, float scale,
                            void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < vec || D % 8 != 0 ||
      D > kMaxDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) p.sb[i] = strides[12 + i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(dtype, D) == 1) return launch_mma(p, s);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
