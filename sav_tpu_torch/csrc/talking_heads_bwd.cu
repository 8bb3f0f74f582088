// Talking-heads attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_th_bwd_kernel` in sav_tpu/ops/talking_heads.py
// (host side `_th_backward`, pallas_call at :335). For all heads of one
// batch element it recomputes S, P and P' from q and k and emits dq, dk, dv
// and the [H, H] gradients of both mixing matrices, with the equations of
// that kernel's docstring and its casts:
//
//   s_h   = (q_h . k_h) * scale, s'_i = sum_h Wpre[h,i] s_h, p_i = softmax(s'_i)
//   p'_i  = sum_h Wpost[h,i] p_h
//   dP'_i = dO_i . v_i^T                    dV_i += (p'_i -> dO dtype)^T dO_i
//   dWpost[h,i] += <p_h, dP'_i>             dP_h  = sum_i Wpost[h,i] dP'_i
//   dS'_i = p_i * (dP_i - rowsum(p_i * dP_i))
//   dWpre[h,i]  += <s_h, dS'_i>             dS_h  = sum_i Wpre[h,i] dS'_i
//   dQ_h  = (dS_h -> k dtype) . k_h * scale dK_h += (dS_h -> k dtype)^T q_h
//
// Every product sums in f32; dk (scaled once at the end) and dv are cast to
// their input dtypes at the end. dO arrives in the q dtype.
//
// What bounds it on the H100: at the CaiT-XXS train shape (B=256, L=196,
// H=4, D=48, bf16) the function reads q, k, v, dO and writes dq, dk, dv,
// ~135 MB, and does five products, ~18.9 GFLOP, so the card's floor is
// memory: ~0.040 ms at 3.35 TB/s.
//
// Two variants, by the forward's rule (th_variant in mma_tiles.cuh,
// exported as `sav_talking_heads_variant` from talking_heads.cu):
//
// - bf16 at 2, 3, 4, 6 or 8 heads of up to 48 (SAV_TH_MMA_HEADS,
//   kThMmaMaxDim in mma_tiles.cuh): TWO tensor-core kernels, each launch
//   counted once. Every product is warp-level mma.sync.m16n8k16 (bf16
//   operands, f32 accumulators); the mixes, exponentials, delta and the dW
//   sums stay f32 on the CUDA cores. The TPU kernel carries dk, dv and dW
//   across a sequential q-block grid; here one kernel owns q rows and one
//   owns kv rows, so every output element has one owner and no block needs
//   another's partial sums (the CUDA-core variant's [B, Lk, H, D] f32
//   scratch is gone), and no atomics: two runs give the same bits.
//   - dq (`talking_heads_bwd_dq_mma_kernel<H, DK>`, first): one block per
//     (batch element, 4 / G row groups of 16 q rows), all heads; K and V of
//     every head stream in 32-row tiles (16 above 4 heads) through a
//     two-stage cp.async ring, twice. Sweep 1 forms S and dP' = dO.V^T of
//     every head, the pre-mix s' and dP = Wpost.dP' in registers, and per
//     row and mixed head an online max, sum of exp and sum of exp * dP:
//     delta = rowsum(p * dP), which the output O cannot give (dP mixes the
//     heads), comes from these sums, and with the row's lse it is stored
//     ([2][B][H][Lq] f32) for the dk/dv kernel. Sweep 2 forms p =
//     2^(s' log2 e - lse), dS' = p (dP - delta), the warp's rows of dW_post
//     (p . dP') and dW_pre (s . dS'), and dS = Wpre.dS' of the warp's heads,
//     rounded to bf16 as the A operand of dS.K straight from the
//     registers. Each thread keeps its dW partials in a fixed order; a
//     fixed shuffle tree and the row groups in order give one [2][H][H]
//     partial per block, which the wrapper sums in a fixed order.
//   - dk/dv (`talking_heads_bwd_dkv_mma_kernel<H, DK>`): one block per
//     (batch element, 4 / G row groups of 16 kv rows), all heads, sweeping
//     the q tiles (q, dO and the dq kernel's lse and delta in a two-stage
//     ring); per tile it recomputes S^T, P^T (0 on q columns past Lq), P'^T,
//     dP'^T and dS^T for its kv rows and adds (P'^T -> bf16).dO to dV and
//     (dS^T -> bf16).Q to dK of the warp's heads.
//   In both, the G warps of a row group split the accumulated heads (HO =
//   H / G each, the largest whose live values stay within a register
//   budget, th_heads_per_warp) and each recompute the scores of every
//   head; above 4 heads a 16-column step forms its scores 8 columns at a
//   time. Head dims below a multiple of 16 are zero-padded in shared
//   memory; kv columns past Lk are -inf after the pre-mix; padded rows are
//   not stored. At CaiT-XXS (H=4, D=48): dq 4 warps of 16 q rows, each all
//   4 heads, 114,816 bytes; dk/dv 4 warps, 2 row groups of 16 kv rows, 2
//   heads a warp, 88,192 bytes; two blocks an SM each.
// - f32 (exact, no TF32: the f32 checks hold 2e-5), and bf16 outside that
//   band: ONE CUDA-core kernel (`talking_heads_bwd_kernel<T, H, R>`),
//   products, mixes and reductions in f32:
//   - The TPU kernel carries dk, dv and dW across a sequential q-block grid.
//     Hopper blocks run in no order, and f32 dK/dV of all heads of one batch
//     element (301 KB at L=196, H=4, D=48) do not fit one block, so: ONE
//     BLOCK PER BATCH ELEMENT, which loops over its q tiles in order. Its
//     f32 dK/dV sums live in a global scratch [B, Lk, H, D] that only this
//     block touches (it stays in L2); on the last tile the block writes dk
//     and dv in their dtypes instead. Each dK/dV element belongs to one
//     thread for the life of the block and is summed over the tiles in
//     order; each dW entry belongs to one warp, whose lanes reduce with a
//     fixed shuffle tree. No atomics: the gradients are bit-reproducible.
//     dW leaves as per-batch f32 partials [B, H, H] (the TPU kernel's),
//     which the wrapper sums in a fixed order.
//   - Per tile of kWarps * R query rows, shared memory holds the f32 S, P
//     and a third buffer that goes dP' -> dS' -> dS in place (each
//     [tile][H][Lk]), p'_i of one head, the tile's q or dO rows of one head,
//     and one head's K or V (rows padded by 16 bytes), streamed head by
//     head.
//   - Each warp owns R rows of the tile for the row-parallel steps (products
//     with lanes over kv columns, softmax, mixes in registers per column).
//   - R (2 or 1) is the largest whose shared memory fits in 227 KB; the
//     Python eligibility rule mirrors `smem_bytes` and `pick_rows`.
// The eligibility rule (which shapes the backward takes at all) is the
// CUDA-core kernel's; the tensor-core kernels take every shape inside it.
// q/k/v/dO are read strided in their [B, L, H, D] layout (unit stride on D;
// 16-byte aligned rows for the tensor-core kernels) and dq/dk/dv written the
// same way; rows past Lq are excluded from every sum.

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
  const void* dout;
  const float* wpre;   // [H, H] f32, contiguous
  const float* wpost;  // [H, H] f32, contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dk_acc;  // [B, Lk, H, D] f32 scratch, contiguous
  float* dv_acc;  // [B, Lk, H, D] f32 scratch, contiguous
  float* dwpre;   // [B, H, H] f32 partials
  float* dwpost;  // [B, H, H] f32 partials
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};

// Dynamic shared memory of one block at `rows` query rows per warp: S, P
// and dP'/dS'/dS of the tile ([tile][H][Lk] f32 each), p' of one head, the
// tile's q or dO rows of one head (f32), the two weights and the two dW
// sums, and one head's K or V (rows padded by 16 bytes).
__host__ __device__ inline size_t smem_bytes(int lk, int h, int d,
                                             int itemsize, int rows) {
  const int vec = 16 / itemsize;
  const int tile = kWarps * rows;
  const int ps = round_up4(lk);
  return ((size_t)3 * tile * h * ps + (size_t)tile * ps + (size_t)tile * d +
          (size_t)4 * round_up4(h * h)) * sizeof(float) +
         (size_t)lk * (d + vec) * itemsize;
}

// Query rows per warp: the largest of 2, 1 that fits; 0 if none does.
inline int pick_rows(int lk, int h, int d, int itemsize) {
  for (int rows = 2; rows >= 1; --rows)
    if (smem_bytes(lk, h, d, itemsize, rows) <= (size_t)kSmemLimit) return rows;
  return 0;
}

// acc[h * H + i] += <X_h, Y_i> over the tile's valid rows, for the pairs
// this warp owns (pair = warp, warp + kWarps, ...); fixed order throughout.
template <int H>
__device__ void pair_dots(const float* X, const float* Y, int ps, int nrows,
                          int Lk, float* acc, int warp, int lane) {
  for (int pair = warp; pair < H * H; pair += kWarps) {
    const int h = pair / H;
    const int i = pair - h * H;
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float* x = X + ((size_t)r * H + h) * ps;
      const float* y = Y + ((size_t)r * H + i) * ps;
      for (int j = lane; j < Lk; j += 32) s = fmaf(x[j], y[j], s);
    }
    s = warp_sum(s);
    if (lane == 0) acc[pair] += s;
  }
}

// Adds `part` to the f32 scratch element of this (j, h, d..d+1), or, on the
// last tile, writes the sum times `scale` to the output in T.
template <typename T>
__device__ __forceinline__ void accumulate2(float* scratch, T* out,
                                            float2 part, bool first,
                                            bool last, float scale) {
  float2 tot = part;
  if (!first) {
    const float2 old = *reinterpret_cast<const float2*>(scratch);
    tot.x = old.x + part.x;
    tot.y = old.y + part.y;
  }
  if (last) {
    Elem<T>::store(out, tot.x * scale);
    Elem<T>::store(out + 1, tot.y * scale);
  } else {
    *reinterpret_cast<float2*>(scratch) = tot;
  }
}

template <typename T, int H, int R>
__global__ void __launch_bounds__(kThreads)
    talking_heads_bwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int kTile = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lq = p.Lq;
  const int Lk = p.Lk;
  const int kstride = D + V;
  const int ps = round_up4(Lk);
  const size_t buf = (size_t)kTile * H * ps;
  const size_t rstride = (size_t)H * ps;  // one row of S, P or C
  float* S = reinterpret_cast<float*>(smem);  // [kTile][H][ps]
  float* P = S + buf;                         // [kTile][H][ps]
  float* C = P + buf;                         // dP' -> dS' -> dS
  float* pp = C + buf;                        // [kTile][ps], p' of one head
  float* xs = pp + (size_t)kTile * ps;        // [kTile][D], q or dO
  const int hh = round_up4(H * H);
  float* wpre = xs + kTile * D;
  float* wpost = wpre + hh;
  float* dwpre = wpost + hh;
  float* dwpost = dwpre + hh;
  T* kv = reinterpret_cast<T*>(dwpost + hh);  // [Lk][D + V]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * R;
  const int half = D / 2;

  for (int i = tid; i < H * H; i += kThreads) {
    wpre[i] = p.wpre[i];
    wpost[i] = p.wpost[i];
    dwpre[i] = 0.f;
    dwpost[i] = 0.f;
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0];
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo[0];
  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0];
  T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0];
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0];
  float* dk_acc = p.dk_acc + (size_t)b * Lk * H * D;
  float* dv_acc = p.dv_acc + (size_t)b * Lk * H * D;

  for (int tile0 = 0; tile0 < Lq; tile0 += kTile) {
    const int nrows = min(kTile, Lq - tile0);
    const bool first = tile0 == 0;
    const bool last = tile0 + kTile >= Lq;

    // 1. S_h = (q_h . k_h) * scale, K_h streamed.
    for (int h = 0; h < H; ++h) {
      __syncthreads();  // kv and xs free
      load_kv<T, kThreads>(kv, kg + h * p.sk[2], p.sk[1], Lk, D);
      load_rows<T, kThreads>(xs, qg + (int64_t)tile0 * p.sq[1] + h * p.sq[2], p.sq[1],
                kTile, nrows, D);
      __syncthreads();
      rows_dot<T, R>(xs, kv, row0, D, Lk, S + row0 * rstride + h * ps,
                     rstride, p.scale, lane);
    }
    __syncwarp();

    // 2. P = softmax of the pre-mixed scores, divided by the row sum.
    for (int r = row0; r < row0 + R && r < nrows; ++r) {
      const float* srow = S + r * rstride;
      float* prow = P + r * rstride;
      float m[H], l[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
      }
      for (int j = lane; j < Lk; j += 32) {
        float s[H];
#pragma unroll
        for (int h = 0; h < H; ++h) s[h] = srow[h * ps + j];
#pragma unroll
        for (int i = 0; i < H; ++i) {
          float x = s[0] * wpre[i];
#pragma unroll
          for (int h = 1; h < H; ++h) x = fmaf(s[h], wpre[h * H + i], x);
          prow[i * ps + j] = x;
          m[i] = fmaxf(m[i], x);
        }
      }
#pragma unroll
      for (int i = 0; i < H; ++i) m[i] = warp_max(m[i]);
      for (int j = lane; j < Lk; j += 32) {
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float e = expf(prow[i * ps + j] - m[i]);
          prow[i * ps + j] = e;
          l[i] += e;
        }
      }
#pragma unroll
      for (int i = 0; i < H; ++i) l[i] = warp_sum(l[i]);
      for (int j = lane; j < Lk; j += 32) {
#pragma unroll
        for (int i = 0; i < H; ++i) prow[i * ps + j] = prow[i * ps + j] / l[i];
      }
    }

    // 3. Per head i: p'_i (rounded to the dO dtype), dP'_i = dO_i . v_i^T,
    //    and dV_i += p'_i^T dO_i over the tile's rows.
    for (int i = 0; i < H; ++i) {
      __syncthreads();  // every warp's P in place; kv, xs and pp free
      load_kv<T, kThreads>(kv, vg + i * p.sv[2], p.sv[1], Lk, D);
      load_rows<T, kThreads>(xs, dog + (int64_t)tile0 * p.sdo[1] + i * p.sdo[2], p.sdo[1],
                kTile, nrows, D);
      for (int e = tid; e < kTile * Lk; e += kThreads) {
        const int r = e / Lk;
        const int j = e - r * Lk;
        float x = 0.f;
        if (r < nrows) {
          const float* col = P + r * rstride + j;
          x = col[0] * wpost[i];
#pragma unroll
          for (int h = 1; h < H; ++h) x = fmaf(col[h * ps], wpost[h * H + i], x);
          x = E::round(x);
        }
        pp[r * ps + j] = x;
      }
      __syncthreads();
      rows_dot<T, R>(xs, kv, row0, D, Lk, C + row0 * rstride + i * ps, rstride,
                     1.f, lane);
      for (int e = tid; e < Lk * half; e += kThreads) {
        const int j = e / half;
        const int d = 2 * (e - j * half);
        float2 acc = make_float2(0.f, 0.f);
        for (int r = 0; r < nrows; ++r) {
          const float pr = pp[r * ps + j];
          const float2 g = *reinterpret_cast<const float2*>(xs + r * D + d);
          acc.x = fmaf(pr, g.x, acc.x);
          acc.y = fmaf(pr, g.y, acc.y);
        }
        accumulate2(dv_acc + ((size_t)j * H + i) * D + d,
                    dvg + j * p.sdv[1] + i * p.sdv[2] + d, acc, first, last,
                    1.f);
      }
    }
    __syncthreads();  // every dP' row in place

    // 4. dWpost[h, i] += <P_h, dP'_i>.
    pair_dots<H>(P, C, ps, nrows, Lk, dwpost, warp, lane);
    __syncthreads();  // step 5 rewrites C

    // 5. dP_h = sum_i Wpost[h, i] dP'_i, then dS'_i = p_i (dP_i - rowsum),
    //    in place, for the warp's rows.
    for (int r = row0; r < row0 + R && r < nrows; ++r) {
      const float* prow = P + r * rstride;
      float* crow = C + r * rstride;
      float rs[H];
#pragma unroll
      for (int i = 0; i < H; ++i) rs[i] = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        float g[H];
#pragma unroll
        for (int k = 0; k < H; ++k) g[k] = crow[k * ps + j];
#pragma unroll
        for (int i = 0; i < H; ++i) {
          float x = g[0] * wpost[i * H];
#pragma unroll
          for (int k = 1; k < H; ++k) x = fmaf(g[k], wpost[i * H + k], x);
          crow[i * ps + j] = x;
          rs[i] = fmaf(prow[i * ps + j], x, rs[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < H; ++i) rs[i] = warp_sum(rs[i]);
      for (int j = lane; j < Lk; j += 32) {
#pragma unroll
        for (int i = 0; i < H; ++i)
          crow[i * ps + j] = prow[i * ps + j] * (crow[i * ps + j] - rs[i]);
      }
    }
    __syncthreads();

    // 6. dWpre[h, i] += <S_h, dS'_i>.
    pair_dots<H>(S, C, ps, nrows, Lk, dwpre, warp, lane);
    __syncthreads();  // step 7 rewrites C

    // 7. dS_h = sum_i Wpre[h, i] dS'_i, rounded to the k dtype, in place.
    for (int r = row0; r < row0 + R && r < nrows; ++r) {
      float* crow = C + r * rstride;
      for (int j = lane; j < Lk; j += 32) {
        float g[H];
#pragma unroll
        for (int i = 0; i < H; ++i) g[i] = crow[i * ps + j];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float x = g[0] * wpre[h * H];
#pragma unroll
          for (int i = 1; i < H; ++i) x = fmaf(g[i], wpre[h * H + i], x);
          crow[h * ps + j] = E::round(x);
        }
      }
    }

    // 8. Per head h: dQ_h = dS_h . k_h * scale for the warp's rows, and
    //    dK_h += dS_h^T q_h over the tile's rows.
    for (int h = 0; h < H; ++h) {
      __syncthreads();  // every dS row in place; kv and xs free
      load_kv<T, kThreads>(kv, kg + h * p.sk[2], p.sk[1], Lk, D);
      load_rows<T, kThreads>(xs, qg + (int64_t)tile0 * p.sq[1] + h * p.sq[2], p.sq[1],
                kTile, nrows, D);
      __syncthreads();
      const float* crow = C + row0 * rstride + h * ps;
      float2 o[R][kMaxPairs];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) o[r][u] = make_float2(0.f, 0.f);
      int j = 0;
      for (; j + 4 <= Lk; j += 4) {
        float4 sr[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          sr[r] = *reinterpret_cast<const float4*>(crow + r * rstride + j);
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            const float2 k0 = E::load2(kv + (size_t)(j + 0) * kstride + d);
            const float2 k1 = E::load2(kv + (size_t)(j + 1) * kstride + d);
            const float2 k2 = E::load2(kv + (size_t)(j + 2) * kstride + d);
            const float2 k3 = E::load2(kv + (size_t)(j + 3) * kstride + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float2 a = o[r][u];
              a.x = fmaf(sr[r].x, k0.x, a.x);
              a.y = fmaf(sr[r].x, k0.y, a.y);
              a.x = fmaf(sr[r].y, k1.x, a.x);
              a.y = fmaf(sr[r].y, k1.y, a.y);
              a.x = fmaf(sr[r].z, k2.x, a.x);
              a.y = fmaf(sr[r].z, k2.y, a.y);
              a.x = fmaf(sr[r].w, k3.x, a.x);
              a.y = fmaf(sr[r].w, k3.y, a.y);
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
            const float2 kk = E::load2(kv + (size_t)j * kstride + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float sj = crow[r * rstride + j];
              o[r][u].x = fmaf(sj, kk.x, o[r][u].x);
              o[r][u].y = fmaf(sj, kk.y, o[r][u].y);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r < nrows) {
          T* dqrow = dqg + (int64_t)(tile0 + row0 + r) * p.sdq[1] + h * p.sdq[2];
#pragma unroll
          for (int u = 0; u < kMaxPairs; ++u) {
            const int d = 2 * lane + 64 * u;
            if (d < D) {
              E::store(dqrow + d, o[r][u].x * p.scale);
              E::store(dqrow + d + 1, o[r][u].y * p.scale);
            }
          }
        }
      }
      for (int e = tid; e < Lk * half; e += kThreads) {
        const int jj = e / half;
        const int d = 2 * (e - jj * half);
        float2 acc = make_float2(0.f, 0.f);
        for (int r = 0; r < nrows; ++r) {
          const float s = C[r * rstride + h * ps + jj];
          const float2 q2 = *reinterpret_cast<const float2*>(xs + r * D + d);
          acc.x = fmaf(s, q2.x, acc.x);
          acc.y = fmaf(s, q2.y, acc.y);
        }
        accumulate2(dk_acc + ((size_t)jj * H + h) * D + d,
                    dkg + jj * p.sdk[1] + h * p.sdk[2] + d, acc, first, last,
                    p.scale);
      }
    }
  }

  // 9. This batch element's dW partials.
  __syncthreads();
  for (int i = tid; i < H * H; i += kThreads) {
    p.dwpre[(size_t)b * H * H + i] = dwpre[i];
    p.dwpost[(size_t)b * H * H + i] = dwpost[i];
  }
}

template <typename T, int H, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, H, p.D, (int)sizeof(T), R);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      talking_heads_bwd_kernel<T, H, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  talking_heads_bwd_kernel<T, H, R><<<p.B, kThreads, smem, stream>>>(p);
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

// The head counts built: CaiT-XXS, XS and S (4, 6, 8), the small CaiT of
// the CPU parity tests (2) and an odd count (3), each checked on the card by
// chip_smoke.py. Not 16: CaiT-M at 224² is outside the shared-memory band
// and trains through the dense recompute, like every count not listed. The
// Python rule mirrors the list (BWD_HEADS).
#define SAV_TH_BWD_HEADS(X) X(2) X(3) X(4) X(6) X(8)

inline bool has_heads(int h) {
#define SAV_TH_CASE(N) \
  case N:              \
    return true;
  switch (h) { SAV_TH_BWD_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return false;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
#define SAV_TH_CASE(N) \
  case N:              \
    return launch_heads<T, N>(p, stream);
  switch (p.H) { SAV_TH_BWD_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- bf16 on the tensor cores: two kernels ----

struct MmaParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* wpre;   // [H, H] f32, contiguous
  const float* wpost;  // [H, H] f32, contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* stats;   // [2][B][H][Lq]: base-2 lse, then delta (dq writes them)
  float* dw;      // [B * q tiles][2][H][H]: dW_pre, dW_post partials
  int B, H, Lq, Lk, D;
  int64_t sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};


// The q-tile owner: one block per (batch element, ROWS q rows), all heads.
// Sweep 1 over the kv tiles forms every row's statistics and delta online;
// sweep 2 forms dS' and dS, adds dS.K to dQ and sums the dW partials.
template <int H, int DK>
__global__ void __launch_bounds__(ThMmaShape<H, 1, DK>::THREADS, ThMmaShape<H, 1, DK>::MIN_BLOCKS)
    talking_heads_bwd_dq_mma_kernel(const MmaParams p) {
  using S = ThMmaShape<H, 1, DK>;
  constexpr int HO = S::HO, G = S::G, ROWS = S::ROWS, THREADS = S::THREADS;
  constexpr int KT = S::KT, LD = S::LD, KS = S::KS, NT = S::NT;
  constexpr int NPASS = S::NPASS, NB = S::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [H][ROWS][LD]
  bf16* dos = qs + H * ROWS * LD;                // [H][ROWS][LD]
  bf16* ks = dos + H * ROWS * LD;                // [2][H][KT][LD]
  bf16* vs = ks + 2 * H * KT * LD;               // [2][H][KT][LD]
  float* wpre = reinterpret_cast<float*>(vs + 2 * H * KT * LD);
  float* wpost = wpre + H * H;

  const int D = p.D;
  const int Lk = p.Lk;
  const int qtiles = (p.Lq + ROWS - 1) / ROWS;
  const int b = blockIdx.x / qtiles;
  const int qt = blockIdx.x - b * qtiles;
  const int q0 = qt * ROWS;
  const int nq = min(ROWS, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rw = warp / G;
  const int wrow = rw * 16;
  const int i0 = G == 1 ? 0 : (warp % G) * HO;  // the warp's heads (dQ, dW rows)
  const bool active = wrow < nq;

  for (int i = threadIdx.x; i < H * H; i += THREADS) {
    wpre[i] = p.wpre[i];
    wpost[i] = p.wpost[i];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_tile_async<THREADS>(qs + h * ROWS * LD, LD,
                             p.q + b * p.sq[0] + (int64_t)q0 * p.sq[1] + h * p.sq[2],
                             p.sq[1], ROWS, nq, DK, D);
    load_tile_async<THREADS>(dos + h * ROWS * LD, LD,
                             p.dout + b * p.sdo[0] + (int64_t)q0 * p.sdo[1] + h * p.sdo[2],
                             p.sdo[1], ROWS, nq, DK, D);
  }
  const int ntiles = (Lk + KT - 1) / KT;
  const int steps = 2 * ntiles;
  auto load_step = [&](int s) {
    const int k0 = (s % ntiles) * KT;
    const int n = min(KT, Lk - k0);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      load_tile_async<THREADS>(ks + ((s & 1) * H + h) * KT * LD, LD,
                               p.k + b * p.sk[0] + (int64_t)k0 * p.sk[1] + h * p.sk[2],
                               p.sk[1], KT, n, DK, D);
      load_tile_async<THREADS>(vs + ((s & 1) * H + h) * KT * LD, LD,
                               p.v + b * p.sv[0] + (int64_t)k0 * p.sv[1] + h * p.sv[2],
                               p.sv[1], KT, n, DK, D);
    }
  };
  load_step(0);
  cp_async_commit();

  // Sweep 1: running max, sum of exp and sum of exp * dP per row and mixed
  // head; then the base-2 lse (in m) and delta (in u).
  float m[2][H], l[2][H], u[2][H];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < H; ++j) {
      m[r][j] = -INFINITY;
      l[r][j] = u[r][j] = 0.f;
    }
  float dq[HO][NT][4];
  float dwpre[HO][H], dwpost[HO][H];  // rows i0.. of each
#pragma unroll
  for (int i = 0; i < HO; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) dwpre[i][j] = dwpost[i][j] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_step(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const bool second = s >= ntiles;
      const int k0 = (s % ntiles) * KT;
      const bf16* kt = ks + (s & 1) * H * KT * LD;
      const bf16* vt = vs + (s & 1) * H * KT * LD;
#pragma unroll
      for (int c = 0; c < KT / 16; ++c) {
        float ds[HO][2][4];  // dS of the warp's heads
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
          // s_h = Q_h.K_h^T and dP'_i = dO_i.V_i^T of every head.
          const int n0 = c * 16 + pass * NB * 8;
          float sc[NB][H][4], dpp[NB][H][4];
          th_heads_scores<H, KS, LD, NB>(sc, qs + wrow * LD, ROWS * LD, kt + n0 * LD,
                                         KT * LD, lane);
          th_heads_scores<H, KS, LD, NB>(dpp, dos + wrow * LD, ROWS * LD, vt + n0 * LD,
                                         KT * LD, lane);
          if (!second) {
            // Pre-mix into sc and dP_j = sum_i Wpost[j, i] dP'_i into dpp,
            // -inf past Lk; then the online sums of the thread's columns.
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float sv[H], gv[H], x[H];
#pragma unroll
                for (int h = 0; h < H; ++h) {
                  sv[h] = sc[nb][h][e] * p.scale;
                  gv[h] = dpp[nb][h][e];
                }
                th_mix<H>(x, sv, wpre);
                const bool valid = k0 + n0 + nb * 8 + 2 * t4 + (e & 1) < Lk;
#pragma unroll
                for (int j = 0; j < H; ++j) {
                  float d = gv[0] * wpost[j * H];
#pragma unroll
                  for (int i = 1; i < H; ++i) d = fmaf(gv[i], wpost[j * H + i], d);
                  sc[nb][j][e] = valid ? x[j] : -INFINITY;
                  dpp[nb][j][e] = d;
                }
              }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int j = 0; j < H; ++j) {
                float cm = -INFINITY;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
                  cm = fmaxf(cm, fmaxf(sc[nb][j][2 * r], sc[nb][j][2 * r + 1]));
                const float mn = fmaxf(m[r][j], cm);
                const float mu = mn == -INFINITY ? 0.f : mn * kLog2e;
                const float alpha = exp2_approx(fmaf(m[r][j], kLog2e, -mu));
                float ls = l[r][j] * alpha, us = u[r][j] * alpha;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                  for (int cc = 0; cc < 2; ++cc) {
                    const float ex = exp2_approx(fmaf(sc[nb][j][2 * r + cc], kLog2e, -mu));
                    ls += ex;
                    us = fmaf(ex, dpp[nb][j][2 * r + cc], us);
                  }
                l[r][j] = ls;
                u[r][j] = us;
                m[r][j] = mn;
              }
            continue;
          }
          // Sweep 2, per element: p, dP, dS' = p (dP - delta); the warp's
          // rows of dW_post (p_j dP'_i) and dW_pre (s_h dS'_j); its heads'
          // dS.
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float sv[H], x[H], pr[H], dsm[H];
#pragma unroll
              for (int h = 0; h < H; ++h) sv[h] = sc[nb][h][e] * p.scale;
              th_mix<H>(x, sv, wpre);
              const bool valid = k0 + n0 + nb * 8 + 2 * t4 + (e & 1) < Lk;
#pragma unroll
              for (int j = 0; j < H; ++j) {
                pr[j] = valid ? exp2_approx(fmaf(x[j], kLog2e, -m[r][j])) : 0.f;
                float d = dpp[nb][0][e] * wpost[j * H];
#pragma unroll
                for (int i = 1; i < H; ++i) d = fmaf(dpp[nb][i][e], wpost[j * H + i], d);
                dsm[j] = pr[j] * (d - u[r][j]);
              }
#pragma unroll
              for (int hh = 0; hh < HO; ++hh) {
                const float pj = th_pick<H>(pr, i0 + hh);
                const float sh = th_pick<H>(sv, i0 + hh);
                float d = dsm[0] * wpre[(i0 + hh) * H];
#pragma unroll
                for (int j = 0; j < H; ++j) {
                  dwpost[hh][j] = fmaf(pj, dpp[nb][j][e], dwpost[hh][j]);
                  dwpre[hh][j] = fmaf(sh, dsm[j], dwpre[hh][j]);
                  if (j > 0) d = fmaf(dsm[j], wpre[(i0 + hh) * H + j], d);
                }
                ds[hh][pass * NB + nb][e] = d;
              }
            }
        }
        if (!second) continue;
        // dQ_h += (dS_h -> bf16) . K_h over the 16 kv rows.
#pragma unroll
        for (int hh = 0; hh < HO; ++hh) {
          uint32_t a[4];
          acc_to_a(a, ds[hh][0], ds[hh][1]);
          const bf16* kh = kt + (i0 + hh) * KT * LD + c * 16 * LD;
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t kb[4];
            load_b2_trans(kb, kh + jp * 16, LD, lane);
            mma_bf16(dq[hh][2 * jp], a, kb[0], kb[1]);
            mma_bf16(dq[hh][2 * jp + 1], a, kb[2], kb[3]);
          }
        }
      }
      if (s == ntiles - 1) {
        // Combine the quad's sums: m becomes the base-2 lse, u delta; the
        // first warp of the row group stores both for the dk/dv kernel.
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < H; ++j) {
            const float mx = quad_max(m[r][j]) * kLog2e;
            const float f = exp2_approx(fmaf(m[r][j], kLog2e, -mx));
            const float ls = quad_sum(l[r][j] * f);
            u[r][j] = quad_sum(u[r][j] * f) / ls;
            m[r][j] = mx + log2f(ls);
            const int row = wrow + g + 8 * r;
            if (i0 == 0 && t4 == 0 && row < nq) {
              const size_t at = ((size_t)b * H + j) * p.Lq + q0 + row;
              p.stats[at] = m[r][j];
              p.stats[(size_t)p.B * H * p.Lq + at] = u[r][j];
            }
          }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (active) {
    bf16* dqg = p.dq + b * p.sdq[0] + (int64_t)q0 * p.sdq[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      if (row >= nq) continue;
#pragma unroll
      for (int hh = 0; hh < HO; ++hh)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * t4;
          if (col < D)
            *reinterpret_cast<uint32_t*>(dqg + row * p.sdq[1] + (i0 + hh) * p.sdq[2] + col) =
                pack_bf16(dq[hh][n][2 * r] * p.scale, dq[hh][n][2 * r + 1] * p.scale);
        }
    }
  }
  // dW partials: a fixed shuffle tree in each warp, then the row groups in
  // order (the K ring is free), one [2][H][H] partial per block.
  float* red = reinterpret_cast<float*>(ks);  // [RW][2][H][H]
#pragma unroll
  for (int hh = 0; hh < HO; ++hh)
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float a = active ? warp_sum(dwpre[hh][j]) : 0.f;
      const float c = active ? warp_sum(dwpost[hh][j]) : 0.f;
      if (lane == 0) {
        red[((rw * 2 + 0) * H + i0 + hh) * H + j] = a;
        red[((rw * 2 + 1) * H + i0 + hh) * H + j] = c;
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * H * H; i += THREADS) {
    float acc = red[i];
    for (int w = 1; w < S::RW; ++w) acc += red[w * 2 * H * H + i];
    p.dw[(size_t)blockIdx.x * 2 * H * H + i] = acc;
  }
}

// The kv-tile owner: one block per (batch element, ROWS kv rows), all
// heads; it sweeps the q tiles, recomputing S^T, P^T (from the dq kernel's
// lse), P'^T, dP'^T and dS^T, and adds (P'^T -> bf16).dO to dV and
// (dS^T -> bf16).Q to dK of the warp's heads.
template <int H, int DK>
__global__ void __launch_bounds__(ThMmaShape<H, 2, DK>::THREADS, ThMmaShape<H, 2, DK>::MIN_BLOCKS)
    talking_heads_bwd_dkv_mma_kernel(const MmaParams p) {
  using S = ThMmaShape<H, 2, DK>;
  constexpr int HO = S::HO, G = S::G, ROWS = S::ROWS, THREADS = S::THREADS;
  constexpr int KT = S::KT, LD = S::LD, KS = S::KS, NT = S::NT;
  constexpr int NPASS = S::NPASS, NB = S::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [H][ROWS][LD]
  bf16* vs = ks + H * ROWS * LD;                 // [H][ROWS][LD]
  bf16* qs = vs + H * ROWS * LD;                 // [2][H][KT][LD]
  bf16* dos = qs + 2 * H * KT * LD;              // [2][H][KT][LD]
  float* wpre = reinterpret_cast<float*>(dos + 2 * H * KT * LD);
  float* wpost = wpre + H * H;
  float* st = wpost + H * H;  // [2][2][H][KT]: per stage lse2, then delta

  const int D = p.D;
  const int Lq = p.Lq;
  const int kvtiles = (p.Lk + ROWS - 1) / ROWS;
  const int b = blockIdx.x / kvtiles;
  const int k0 = (blockIdx.x - b * kvtiles) * ROWS;
  const int nk = min(ROWS, p.Lk - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv0 = (warp / G) * 16;
  const int i0 = G == 1 ? 0 : (warp % G) * HO;  // the warp's heads (dK, dV)
  const bool active = kv0 < nk;

  for (int i = threadIdx.x; i < H * H; i += THREADS) {
    wpre[i] = p.wpre[i];
    wpost[i] = p.wpost[i];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_tile_async<THREADS>(ks + h * ROWS * LD, LD,
                             p.k + b * p.sk[0] + (int64_t)k0 * p.sk[1] + h * p.sk[2],
                             p.sk[1], ROWS, nk, DK, D);
    load_tile_async<THREADS>(vs + h * ROWS * LD, LD,
                             p.v + b * p.sv[0] + (int64_t)k0 * p.sv[1] + h * p.sv[2],
                             p.sv[1], ROWS, nk, DK, D);
  }
  const float* lseg = p.stats + (size_t)b * H * Lq;
  const float* deltag = lseg + (size_t)p.B * H * Lq;
  const int ntq = (Lq + KT - 1) / KT;
  auto load_q_tile = [&](int t) {
    const int q0 = t * KT;
    const int n = min(KT, Lq - q0);
    const int stage = t & 1;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      load_tile_async<THREADS>(qs + (stage * H + h) * KT * LD, LD,
                               p.q + b * p.sq[0] + (int64_t)q0 * p.sq[1] + h * p.sq[2],
                               p.sq[1], KT, n, DK, D);
      load_tile_async<THREADS>(dos + (stage * H + h) * KT * LD, LD,
                               p.dout + b * p.sdo[0] + (int64_t)q0 * p.sdo[1] + h * p.sdo[2],
                               p.sdo[1], KT, n, DK, D);
    }
    for (int i = threadIdx.x; i < 2 * H * KT; i += THREADS) {
      const int c = i % KT;
      const int jh = i / KT;  // 0..H-1 lse, H..2H-1 delta
      const float* src = (jh < H ? lseg + (size_t)jh * Lq
                                 : deltag + (size_t)(jh - H) * Lq) + q0 + c;
      cp_async4(st + stage * 2 * H * KT + i, c < n ? src : lseg, c < n);
    }
  };
  load_q_tile(0);
  cp_async_commit();

  float dk[HO][NT][4], dv[HO][NT][4];
#pragma unroll
  for (int i = 0; i < HO; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][n][e] = dv[i][n][e] = 0.f;

  for (int t = 0; t < ntq; ++t) {
    if (t + 1 < ntq) load_q_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const int stage = t & 1;
      const bf16* qt = qs + stage * H * KT * LD;
      const bf16* dt = dos + stage * H * KT * LD;
      const float* lse2 = st + stage * 2 * H * KT;
      const float* delta = lse2 + H * KT;
      const int nq = min(KT, Lq - t * KT);
#pragma unroll
      for (int c = 0; c < KT / 16; ++c) {
        float pp[HO][2][4], ds[HO][2][4];  // P'^T and dS^T of the warp's heads
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
          // S^T_h = K_h.Q_h^T and dP'^T_i = V_i.dO_i^T: the warp's 16 kv
          // rows by 8 NB q columns.
          const int n0 = c * 16 + pass * NB * 8;
          float sc[NB][H][4], dpp[NB][H][4];
          th_heads_scores<H, KS, LD, NB>(sc, ks + kv0 * LD, ROWS * LD, qt + n0 * LD,
                                         KT * LD, lane);
          th_heads_scores<H, KS, LD, NB>(dpp, vs + kv0 * LD, ROWS * LD, dt + n0 * LD,
                                         KT * LD, lane);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + nb * 8 + 2 * t4 + (e & 1);
              const bool valid = col < nq;  // p is 0 on q columns past Lq
              float sv[H], x[H], pr[H], dsm[H];
#pragma unroll
              for (int h = 0; h < H; ++h) sv[h] = sc[nb][h][e] * p.scale;
              th_mix<H>(x, sv, wpre);
#pragma unroll
              for (int j = 0; j < H; ++j) {
                pr[j] = valid ? exp2_approx(fmaf(x[j], kLog2e, -lse2[j * KT + col])) : 0.f;
                float d = dpp[nb][0][e] * wpost[j * H];
#pragma unroll
                for (int i = 1; i < H; ++i) d = fmaf(dpp[nb][i][e], wpost[j * H + i], d);
                dsm[j] = pr[j] * (d - delta[j * KT + col]);
              }
#pragma unroll
              for (int i = 0; i < HO; ++i) {
                float v = pr[0] * wpost[i0 + i];
                float d = dsm[0] * wpre[(i0 + i) * H];
#pragma unroll
                for (int j = 1; j < H; ++j) {
                  v = fmaf(pr[j], wpost[j * H + i0 + i], v);
                  d = fmaf(dsm[j], wpre[(i0 + i) * H + j], d);
                }
                pp[i][pass * NB + nb][e] = v;
                ds[i][pass * NB + nb][e] = d;
              }
            }
        }
        // dV_i += (P'^T_i -> bf16).dO_i, dK_h += (dS^T_h -> bf16).Q_h over
        // the chunk's 16 q rows.
#pragma unroll
        for (int i = 0; i < HO; ++i) {
          uint32_t pa[4], sa[4];
          acc_to_a(pa, pp[i][0], pp[i][1]);
          acc_to_a(sa, ds[i][0], ds[i][1]);
          const bf16* dh = dt + (i0 + i) * KT * LD + c * 16 * LD;
          const bf16* qh = qt + (i0 + i) * KT * LD + c * 16 * LD;
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t gb[4], qb[4];
            load_b2_trans(gb, dh + jp * 16, LD, lane);
            load_b2_trans(qb, qh + jp * 16, LD, lane);
            mma_bf16(dv[i][2 * jp], pa, gb[0], gb[1]);
            mma_bf16(dv[i][2 * jp + 1], pa, gb[2], gb[3]);
            mma_bf16(dk[i][2 * jp], sa, qb[0], qb[1]);
            mma_bf16(dk[i][2 * jp + 1], sa, qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
  bf16* dkg = p.dk + b * p.sdk[0] + (int64_t)k0 * p.sdk[1];
  bf16* dvg = p.dv + b * p.sdv[0] + (int64_t)k0 * p.sdv[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + g + 8 * r;
    if (row >= nk) continue;
#pragma unroll
    for (int i = 0; i < HO; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < D) {
          *reinterpret_cast<uint32_t*>(dkg + row * p.sdk[1] + (i0 + i) * p.sdk[2] + col) =
              pack_bf16(dk[i][n][2 * r] * p.scale, dk[i][n][2 * r + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvg + row * p.sdv[1] + (i0 + i) * p.sdv[2] + col) =
              pack_bf16(dv[i][n][2 * r], dv[i][n][2 * r + 1]);
        }
      }
  }
}

template <int H, int KIND, int DK>
int launch_mma_hd(const MmaParams& p, cudaStream_t stream) {
  using S = ThMmaShape<H, KIND, DK>;
  const auto kernel = KIND == 1 ? talking_heads_bwd_dq_mma_kernel<H, DK>
                                : talking_heads_bwd_dkv_mma_kernel<H, DK>;
  const size_t smem = th_mma_smem_bytes(KIND, H, DK);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = KIND == 1 ? p.Lq : p.Lk;
  const int blocks = (rows + S::ROWS - 1) / S::ROWS * p.B;
  kernel<<<blocks, S::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int H, int KIND>
int launch_mma_heads(const MmaParams& p, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_hd<H, KIND, 16>(p, stream);
    case 2: return launch_mma_hd<H, KIND, 32>(p, stream);
    case 3: return launch_mma_hd<H, KIND, 48>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int KIND>
int launch_mma(const MmaParams& p, cudaStream_t stream) {
#define SAV_TH_CASE(N) \
  case N:              \
    return launch_mma_heads<N, KIND>(p, stream);
  switch (p.H) { SAV_TH_MMA_HEADS(SAV_TH_CASE) }
#undef SAV_TH_CASE
  return (int)cudaErrorInvalidValue;
}


}  // namespace

extern "C" {

// Shared-memory bytes of one block at `rows` query rows per warp, and the
// rows the launcher picks (0: the shape does not fit). The Python
// eligibility rule mirrors both.
size_t sav_talking_heads_bwd_smem_bytes(int lk, int h, int d, int itemsize,
                                        int rows) {
  return smem_bytes(lk, h, d, itemsize, rows);
}

int sav_talking_heads_bwd_rows(int lk, int h, int d, int itemsize) {
  return pick_rows(lk, h, d, itemsize);
}

// 1 when the kernel is built for `h` heads (SAV_TH_BWD_HEADS), else 0.
int sav_talking_heads_bwd_has_heads(int h) { return has_heads(h) ? 1 : 0; }

// kind 1: the dq kernel, 2: the dk/dv kernel. Heads per warp, shared
// memory per block and rows a block owns at h heads and padded head dim dk;
// the Python rules mirror all three, and the wrapper sizes dq's dW
// partials ([B * q tiles][2][H][H]) from the library's own rows.
int sav_talking_heads_bwd_mma_heads_per_warp(int kind, int h, int dk) {
  return th_heads_per_warp(kind, h, dk);
}
size_t sav_talking_heads_bwd_mma_smem_bytes(int kind, int h, int dk) {
  return th_mma_smem_bytes(kind, h, dk);
}
int sav_talking_heads_bwd_mma_rows(int kind, int h, int dk) {
  return th_mma_rows(kind, h, dk);
}

// The two tensor-core kernels (bf16; variant 1 only), the dq kernel first:
// it writes stats ([2][B][H][Lq] f32: base-2 lse, delta) that the dk/dv
// kernel reads, and dw ([B * q tiles][2][H][H] f32: dW_pre, dW_post
// partials per block). strides: 21 element strides, in order q, k, v, dO,
// dq, dk, dv, each (b, l, h). Returns a cudaError_t; 0 means launched.
int sav_talking_heads_bwd_mma(int kind, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* wpre, const float* wpost, void* dq,
                              void* dk, void* dv, float* stats, float* dw,
                              int B, int H, int Lq, int Lk, int D,
                              const int64_t* strides, float scale,
                              void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || D < 8 || D % 8 != 0 ||
      th_variant(1, H, D) != 1 || (kind != 1 && kind != 2))
    return (int)cudaErrorInvalidValue;
  MmaParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.wpre = wpre;
  p.wpost = wpost;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.stats = stats;
  p.dw = dw;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sdo[i] = strides[9 + i];
    p.sdq[i] = strides[12 + i];
    p.sdk[i] = strides[15 + i];
    p.sdv[i] = strides[18 + i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == 1 ? launch_mma<1>(p, s) : launch_mma<2>(p, s);
}

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq, dk, dv all of it).
// strides: 21 element strides, in order q, k, v, dO, dq, dk, dv, each
// (b, l, h). wpre/wpost: [H, H] f32. dk_acc/dv_acc: [B, Lk, H, D] f32
// scratch. dwpre/dwpost: [B, H, H] f32 partials.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_talking_heads_bwd(int dtype, const void* q, const void* k,
                          const void* v, const void* dout, const float* wpre,
                          const float* wpost, void* dq, void* dk, void* dv,
                          float* dk_acc, float* dv_acc, float* dwpre,
                          float* dwpost, int B, int H, int Lq, int Lk, int D,
                          const int64_t* strides, float scale, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < vec || D % 8 != 0 ||
      D > kMaxDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.wpre = wpre;
  p.wpost = wpost;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dk_acc = dk_acc;
  p.dv_acc = dv_acc;
  p.dwpre = dwpre;
  p.dwpost = dwpost;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sdo[i] = strides[9 + i];
    p.sdq[i] = strides[12 + i];
    p.sdk[i] = strides[15 + i];
    p.sdv[i] = strides[18 + i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
