// Talking-heads attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_th_kernel` in sav_tpu/ops/talking_heads.py
// (driver `_th_forward`, pallas_call at :135). It computes what that kernel
// computes, in its order, for all heads of one batch element at once:
//
//   s_h   = (q_h . k_h) * scale           f32 product, THEN the scale
//   s'_i  = sum_h Wpre[h, i] * s_h        pre-softmax head mix, f32 weights
//   p_i   = exp(s'_i - max) / sum         exact row softmax, divided BEFORE
//   p'_i  = sum_h Wpost[h, i] * p_h       the post-softmax head mix
//   o_i   = (p'_i -> value dtype) . v_i   f32 sum, cast to the output dtype
//
// The mixing weights stay f32 under bf16 (the TPU kernel reads its f32
// parameter uncast). The [B, H, Lq, Lk] scores and probabilities never
// reach device memory.
//
// What bounds it on the H100: at the CaiT-XXS train shape (B=256, L=196,
// H=4, D=48, bf16) the function moves ~77 MB (q, k, v, o once each) and does
// ~7.6 GFLOP of products plus ~0.6 GFLOP of f32 mixing, so the card's floor
// is memory: ~0.023 ms at 3.35 TB/s.
//
// Two variants, chosen by the C entry point (`sav_talking_heads_variant`),
// each launch counted once:
//
// - bf16 at 2, 3, 4, 6 or 8 heads of up to 48 (SAV_TH_MMA_HEADS,
//   kThMmaMaxDim in mma_tiles.cuh): tensor cores
//   (`talking_heads_fwd_mma_kernel<H, DK>`). QK^T and P'V are warp-level
//   mma.sync.m16n8k16 (bf16 operands, f32 accumulators); the mixes, the
//   exponentials and the row statistics stay f32 on the CUDA cores. The
//   reference rounds p' to bf16 after the post-mix of the NORMALISED p, so
//   every p' needs its row's max and sum of every mixed head first: the
//   block sweeps the kv row twice, as the fused forward does. Sweep 1 forms
//   S of every head for 16 columns at a time, pre-mixes them in registers
//   (the heads of one (row, column) sit at the same fragment positions of
//   every head's accumulators) and keeps an online max and sum per row and
//   mixed head; the quad's sums then give a base-2 lse. Sweep 2 recomputes
//   S, forms p = 2^(s' log2 e - lse) (the SFU's ex2), post-mixes p for the
//   warp's output heads, rounds to bf16 as the A operand of P'.V straight
//   from the registers, and adds to O. A block owns 4 / G row groups of 16
//   q rows, all heads; the G warps of a group split the output heads (HO =
//   H / G each, the largest whose O and scores stay within a register
//   budget) and each recompute the scores. K (sweep 1) and K, V (sweep 2) of
//   every head stream in 32-row tiles (16 above 4 heads) through a
//   two-stage cp.async ring, zero-filled past Lk; a head dim below a
//   multiple of 16 is zero-padded in shared memory. Columns past Lk are -inf
//   after the pre-mix, where the TPU kernel masks. At CaiT-XXS (H=4, D=48)
//   a block is 4 warps of 16 q rows, one warp all 4 heads, 86,144 bytes of
//   shared memory: two blocks an SM.
// - f32 (exact, no TF32: the f32 checks hold 2e-5), and bf16 outside that
//   band (16 heads, head dims above 48): CUDA cores
//   (`talking_heads_fwd_kernel<T, H, R>`), products and mixes in f32:
//   - The heads are coupled, so one block owns every head of one batch
//     element for one tile of kWarps * R query rows (grid: q tiles x B).
//   - Whole K/V of all heads do not fit one block in f32 (301 KB at L=196,
//     H=4, D=48), so K_h and then V_h stream through shared memory one head
//     at a time, while the tile's f32 scores of every head stay in shared
//     memory ([tile rows][H][Lk], rows padded to a multiple of 4 columns).
//   - Columns past Lk do not exist in the loops, which is where the TPU
//     kernel puts -inf after the mix.
//   - Each warp owns R query rows in every phase. Scores: lanes stride over
//     the kv columns and reuse each K chunk for the warp's R rows. Mix and
//     softmax: lanes stride over columns, the H values of a column are
//     mixed in registers and written back in place (a column's mix reads
//     only that column); warp shuffles give the row max and sum. PV: lanes
//     own pairs of output columns and sweep the kv rows.
//   - R (2, or 1) is the largest whose shared memory fits in 227 KB; the
//     Python eligibility rule mirrors `smem_bytes` and `pick_rows`. H is a
//     template parameter so the per-column head vectors stay in registers;
//     only the head counts in SAV_TH_HEADS are built.
// The eligibility rule (which shapes the kernel takes at all) is the
// CUDA-core variant's; the tensor-core variant takes every shape inside it.
// q/k/v/o are read and written strided in their [B, L, H, D] layout (unit
// stride on D; 16-byte aligned rows where the tensor cores copy q); rows
// past Lq are computed on zero queries and not stored.

#include <math.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 128;              // largest head dim
constexpr int kMaxPairs = kMaxDim / 64;   // output column pairs per lane
constexpr int kSmemLimit = 232448;        // dynamic shared memory per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* wpre;   // [H, H] f32, contiguous
  const float* wpost;  // [H, H] f32, contiguous
  void* o;
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3];
  float scale;
};

// Dynamic shared memory of one block at `rows` query rows per warp: the
// tile's f32 scores of every head, its f32 query rows of one head, both
// [H, H] weights, and one head's K or V (rows padded by 16 bytes).
__host__ __device__ inline size_t smem_bytes(int lk, int h, int d,
                                             int itemsize, int rows) {
  const int vec = 16 / itemsize;
  const int tile = kWarps * rows;
  return (size_t)tile * h * round_up4(lk) * sizeof(float) +
         (size_t)tile * d * sizeof(float) +
         (size_t)2 * round_up4(h * h) * sizeof(float) +
         (size_t)lk * (d + vec) * itemsize;
}

// Query rows per warp: the largest of 2, 1 that fits; 0 if none does.
inline int pick_rows(int lk, int h, int d, int itemsize) {
  for (int rows = 2; rows >= 1; --rows)
    if (smem_bytes(lk, h, d, itemsize, rows) <= (size_t)kSmemLimit) return rows;
  return 0;
}

template <typename T, int H, int R>
__global__ void __launch_bounds__(kThreads)
    talking_heads_fwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int kTile = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lk = p.Lk;
  const int kstride = D + V;
  const int ps = round_up4(Lk);
  float* sc = reinterpret_cast<float*>(smem);     // [kTile][H][ps]
  float* qs = sc + (size_t)kTile * H * ps;        // [kTile][D]
  float* wpre = qs + kTile * D;                   // [H][H]
  float* wpost = wpre + round_up4(H * H);         // [H][H]
  T* kv = reinterpret_cast<T*>(wpost + round_up4(H * H));  // [Lk][D + V]

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * R;  // the warp's first row in the tile
  const int nrows = min(kTile, p.Lq - tile0);

  for (int i = tid; i < H * H; i += kThreads) {
    wpre[i] = p.wpre[i];
    wpost[i] = p.wpost[i];
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0];
  T* og = static_cast<T*>(p.o) + b * p.so[0];

  // 1. s_h = (q_h . k_h) * scale for every head, K_h streamed.
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's readers are done with kv and qs
    load_kv<T, kThreads>(kv, kg + h * p.sk[2], p.sk[1], Lk, D);
    load_rows<T, kThreads>(qs, qg + (int64_t)tile0 * p.sq[1] + h * p.sq[2], p.sq[1],
                           kTile, nrows, D);
    __syncthreads();
    rows_dot<T, R>(qs, kv, row0, D, Lk, sc + ((size_t)row0 * H + h) * ps,
                   (size_t)H * ps, p.scale, lane);
  }
  __syncwarp();  // the mix reads every lane's columns of the warp's rows

  // 2. Per row: pre-mix, exact softmax, division by the row sum, post-mix,
  //    rounding to the value dtype; in place, column by column.
  for (int r = row0; r < row0 + R && r < nrows; ++r) {
    float* row = sc + (size_t)r * H * ps;
    float m[H];
#pragma unroll
    for (int i = 0; i < H; ++i) m[i] = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      float s[H];
#pragma unroll
      for (int h = 0; h < H; ++h) s[h] = row[h * ps + j];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float x = s[0] * wpre[i];
#pragma unroll
        for (int h = 1; h < H; ++h) x = fmaf(s[h], wpre[h * H + i], x);
        row[i * ps + j] = x;
        m[i] = fmaxf(m[i], x);
      }
    }
    float l[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      m[i] = warp_max(m[i]);
      l[i] = 0.f;
    }
    for (int j = lane; j < Lk; j += 32) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float e = expf(row[i * ps + j] - m[i]);
        row[i * ps + j] = e;
        l[i] += e;
      }
    }
#pragma unroll
    for (int i = 0; i < H; ++i) l[i] = warp_sum(l[i]);
    for (int j = lane; j < Lk; j += 32) {
      float pr[H];
#pragma unroll
      for (int h = 0; h < H; ++h) pr[h] = row[h * ps + j] / l[h];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float x = pr[0] * wpost[i];
#pragma unroll
        for (int h = 1; h < H; ++h) x = fmaf(pr[h], wpost[h * H + i], x);
        row[i * ps + j] = E::round(x);
      }
    }
  }

  // 3. o_i = p'_i . v_i, V_i streamed; lane owns the column pairs
  //    d = 2 * lane + 64 * u.
  for (int i = 0; i < H; ++i) {
    __syncthreads();  // kv free, and every warp's p' in place
    load_kv<T, kThreads>(kv, vg + i * p.sv[2], p.sv[1], Lk, D);
    __syncthreads();
    float2 o[R][kMaxPairs];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) o[r][u] = make_float2(0.f, 0.f);
    const float* prow = sc + ((size_t)row0 * H + i) * ps;
    const size_t rstride = (size_t)H * ps;
    int j = 0;
    for (; j + 4 <= Lk; j += 4) {
      float4 pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pr[r] = *reinterpret_cast<const float4*>(prow + r * rstride + j);
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 v0 = E::load2(kv + (size_t)(j + 0) * kstride + d);
          const float2 v1 = E::load2(kv + (size_t)(j + 1) * kstride + d);
          const float2 v2 = E::load2(kv + (size_t)(j + 2) * kstride + d);
          const float2 v3 = E::load2(kv + (size_t)(j + 3) * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
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
          const float2 vv = E::load2(kv + (size_t)j * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float pj = prow[r * rstride + j];
            o[r][u].x = fmaf(pj, vv.x, o[r][u].x);
            o[r][u].y = fmaf(pj, vv.y, o[r][u].y);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < nrows) {
        T* orow = og + (int64_t)(tile0 + row0 + r) * p.so[1] + i * p.so[2];
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            E::store(orow + d, o[r][u].x);
            E::store(orow + d + 1, o[r][u].y);
          }
        }
      }
    }
  }
}

template <typename T, int H, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, H, p.D, (int)sizeof(T), R);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      talking_heads_fwd_kernel<T, H, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int tile = kWarps * R;
  const dim3 grid((p.Lq + tile - 1) / tile, p.B);
  talking_heads_fwd_kernel<T, H, R><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int launch_heads(const Params& p, cudaStream_t stream) {
  switch (pick_rows(p.Lk, H, p.D, (int)sizeof(T))) {
    case 2:
      return launch_rows<T, H, 2>(p, stream);
    case 1:
      return launch_rows<T, H, 1>(p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The head counts built: CaiT-XXS, XS, S and M (4, 6, 8, 16), the small
// CaiT of the CPU parity tests (2) and an odd count (3), each checked on the
// card by chip_smoke.py. Any other count is outside the band, where `auto`
// takes the dense path; the Python rule mirrors the list (HEADS).
#define SAV_TH_HEADS(X) X(2) X(3) X(4) X(6) X(8) X(16)

inline bool has_heads(int h) {
#define SAV_TH_CASE(N) \
  case N:              \
    return true;
  switch (h) { SAV_TH_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return false;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
#define SAV_TH_CASE(N) \
  case N:              \
    return launch_heads<T, N>(p, stream);
  switch (p.H) { SAV_TH_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- bf16 on the tensor cores ----

// What one warp does per 16-column chunk of a kv tile, sweep 1 (stats) and
// sweep 2 (output), for rows g and g + 8 of its 16 (e >> 1 of each
// fragment element e) and columns kc + 8n + 2t + (e & 1).
template <int H, int DK>
__global__ void __launch_bounds__(ThMmaShape<H, 0, DK>::THREADS,
                                  ThMmaShape<H, 0, DK>::MIN_BLOCKS)
    talking_heads_fwd_mma_kernel(const Params p) {
  using S = ThMmaShape<H, 0, DK>;
  constexpr int HO = S::HO, G = S::G, ROWS = S::ROWS, THREADS = S::THREADS;
  constexpr int KT = S::KT, LD = S::LD, KS = S::KS, NT = S::NT;
  constexpr int NPASS = S::NPASS, NB = S::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [H][ROWS][LD]
  bf16* ks = qs + H * ROWS * LD;                 // [2][H][KT][LD]
  bf16* vs = ks + 2 * H * KT * LD;               // [2][H][KT][LD]
  float* wpre = reinterpret_cast<float*>(vs + 2 * H * KT * LD);
  float* wpost = wpre + H * H;

  const int D = p.D;
  const int Lk = p.Lk;
  const int qtiles = (p.Lq + ROWS - 1) / ROWS;
  const int b = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x - b * qtiles) * ROWS;
  const int nq = min(ROWS, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = (warp / G) * 16;  // the warp's first row in the block
  const int i0 = G == 1 ? 0 : (warp % G) * HO;  // its first output head
  const bool active = wrow < nq;

  for (int i = threadIdx.x; i < H * H; i += THREADS) {
    wpre[i] = p.wpre[i];
    wpost[i] = p.wpost[i];
  }
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] +
                   (int64_t)q0 * p.sq[1];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0];
#pragma unroll
  for (int h = 0; h < H; ++h)
    load_tile_async<THREADS>(qs + h * ROWS * LD, LD, qg + h * p.sq[2],
                             p.sq[1], ROWS, nq, DK, D);
  const int ntiles = (Lk + KT - 1) / KT;
  const int steps = 2 * ntiles;  // K tiles for the statistics, then K and V
  // Step s's tiles into ring stage s & 1: K of tile s % ntiles, and V in
  // the second sweep.
  auto load_step = [&](int s) {
    const int k0 = (s % ntiles) * KT;
    const int n = min(KT, Lk - k0);
    bf16* kd = ks + (s & 1) * H * KT * LD;
    bf16* vd = vs + (s & 1) * H * KT * LD;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      load_tile_async<THREADS>(kd + h * KT * LD, LD,
                               kg + (int64_t)k0 * p.sk[1] + h * p.sk[2],
                               p.sk[1], KT, n, DK, D);
      if (s >= ntiles)
        load_tile_async<THREADS>(vd + h * KT * LD, LD,
                                 vg + (int64_t)k0 * p.sv[1] + h * p.sv[2],
                                 p.sv[1], KT, n, DK, D);
    }
  };
  load_step(0);
  cp_async_commit();

  // Per row (g, g + 8) and mixed head: the running max and sum of sweep 1,
  // then the base-2 log-sum-exp.
  float m[2][H], l[2][H];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < H; ++j) {
      m[r][j] = -INFINITY;
      l[r][j] = 0.f;
    }
  float o[HO][NT][4];
#pragma unroll
  for (int i = 0; i < HO; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_step(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if (active) {
      const bool second = s >= ntiles;
      const int k0 = (s % ntiles) * KT;
      const bf16* kt = ks + (s & 1) * H * KT * LD;
      const bf16* vt = vs + (s & 1) * H * KT * LD;
#pragma unroll
      for (int c = 0; c < KT / 16; ++c) {
        float pp[HO][2][4];  // the post-mixed p of the warp's heads
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
          // Scores of every head, then the pre-mix in place, -inf past Lk.
          float x[NB][H][4];
          th_heads_scores<H, KS, LD, NB>(x, qs + wrow * LD, ROWS * LD,
                                         kt + (c * 16 + pass * NB * 8) * LD,
                                         KT * LD, lane);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float sv[H], mx[H];
#pragma unroll
              for (int h = 0; h < H; ++h) sv[h] = x[nb][h][e] * p.scale;
              th_mix<H>(mx, sv, wpre);
              const int col = k0 + c * 16 + (pass * NB + nb) * 8 + 2 * t4 + (e & 1);
#pragma unroll
              for (int j = 0; j < H; ++j) x[nb][j][e] = col < Lk ? mx[j] : -INFINITY;
            }
          if (!second) {
            // Online max and sum over the thread's columns (combined across
            // the quad after the sweep).
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int j = 0; j < H; ++j) {
                float cm = -INFINITY;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
                  cm = fmaxf(cm, fmaxf(x[nb][j][2 * r], x[nb][j][2 * r + 1]));
                const float mn = fmaxf(m[r][j], cm);
                const float mu = mn == -INFINITY ? 0.f : mn * kLog2e;
                float sum = l[r][j] * exp2_approx(fmaf(m[r][j], kLog2e, -mu));
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                  for (int cc = 0; cc < 2; ++cc)
                    sum += exp2_approx(fmaf(x[nb][j][2 * r + cc], kLog2e, -mu));
                l[r][j] = sum;
                m[r][j] = mn;
              }
            continue;
          }
          // p = exp(s' - lse) in place, then the post-mix of the warp's
          // heads.
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int j = 0; j < H; ++j)
                x[nb][j][e] = exp2_approx(fmaf(x[nb][j][e], kLog2e, -m[e >> 1][j]));
#pragma unroll
              for (int i = 0; i < HO; ++i) {
                float v = x[nb][0][e] * wpost[i0 + i];
#pragma unroll
                for (int j = 1; j < H; ++j) v = fmaf(x[nb][j][e], wpost[j * H + i0 + i], v);
                pp[i][pass * NB + nb][e] = v;
              }
            }
        }
        if (!second) continue;
        // O_i += (p'_i -> bf16) . V_i over the 16 kv rows.
#pragma unroll
        for (int i = 0; i < HO; ++i) {
          uint32_t a[4];
          acc_to_a(a, pp[i][0], pp[i][1]);
          const bf16* vh = vt + (i0 + i) * KT * LD + c * 16 * LD;
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t vb[4];
            load_b2_trans(vb, vh + jp * 16, LD, lane);
            mma_bf16(o[i][2 * jp], a, vb[0], vb[1]);
            mma_bf16(o[i][2 * jp + 1], a, vb[2], vb[3]);
          }
        }
      }
      if (s == ntiles - 1) {
        // The rows' statistics: m[r][j] becomes the base-2 log-sum-exp.
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < H; ++j) {
            const float mx = quad_max(m[r][j]) * kLog2e;
            const float sum = quad_sum(l[r][j] * exp2_approx(fmaf(m[r][j], kLog2e, -mx)));
            m[r][j] = mx + log2f(sum);
          }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
  bf16* og = static_cast<bf16*>(p.o) + b * p.so[0] + (int64_t)q0 * p.so[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int i = 0; i < HO; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < D)
          *reinterpret_cast<uint32_t*>(og + row * p.so[1] + (i0 + i) * p.so[2] + col) =
              pack_bf16(o[i][n][2 * r], o[i][n][2 * r + 1]);
      }
  }
}

template <int H, int DK>
int launch_mma_hd(const Params& p, cudaStream_t stream) {
  using S = ThMmaShape<H, 0, DK>;
  const size_t smem = th_mma_smem_bytes(0, H, DK);
  cudaError_t err = cudaFuncSetAttribute(
      talking_heads_fwd_mma_kernel<H, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.Lq + S::ROWS - 1) / S::ROWS * p.B;
  talking_heads_fwd_mma_kernel<H, DK><<<blocks, S::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int H>
int launch_mma_heads(const Params& p, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_hd<H, 16>(p, stream);
    case 2: return launch_mma_hd<H, 32>(p, stream);
    case 3: return launch_mma_hd<H, 48>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_mma(const Params& p, cudaStream_t stream) {
#define SAV_TH_CASE(N) \
  case N:              \
    return launch_mma_heads<N>(p, stream);
  switch (p.H) { SAV_TH_MMA_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return (int)cudaErrorInvalidValue;
}


}  // namespace

extern "C" {

// Shared-memory bytes of one block at `rows` query rows per warp, and the
// rows the launcher picks (0: the shape does not fit). The Python
// eligibility rule mirrors both.
size_t sav_talking_heads_smem_bytes(int lk, int h, int d, int itemsize,
                                    int rows) {
  return smem_bytes(lk, h, d, itemsize, rows);
}

int sav_talking_heads_rows(int lk, int h, int d, int itemsize) {
  return pick_rows(lk, h, d, itemsize);
}

// 1 when the kernel is built for `h` heads (SAV_TH_HEADS), else 0.
int sav_talking_heads_has_heads(int h) { return has_heads(h) ? 1 : 0; }

// dtype 0 = float32, 1 = bfloat16 -> 1 (tensor cores) for h heads of dim
// d inside the bf16 band, else 0 (CUDA cores).
int sav_talking_heads_variant(int dtype, int h, int d) {
  return th_variant(dtype, h, d);
}

// The tensor-core variant's output heads per warp and shared-memory bytes
// per block at h heads and padded head dim dk; the Python rules mirror
// both.
int sav_talking_heads_mma_heads_per_warp(int h, int dk) {
  return th_heads_per_warp(0, h, dk);
}
size_t sav_talking_heads_mma_smem_bytes(int h, int dk) {
  return th_mma_smem_bytes(0, h, dk);
}

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in order
// q, k, v, o, each (b, l, h). wpre/wpost: [H, H] f32, contiguous.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_talking_heads_fwd(int dtype, const void* q, const void* k,
                          const void* v, const float* wpre,
                          const float* wpost, void* o, int B, int H, int Lq,
                          int Lk, int D, const int64_t* strides, float scale,
                          void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < vec || D % 8 != 0 ||
      D > kMaxDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.wpre = wpre;
  p.wpost = wpost;
  p.o = o;
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (th_variant(dtype, H, D) == 1) return launch_mma(p, s);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
