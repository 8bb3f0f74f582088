// Fused attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bwd_kernel` in sav_tpu/ops/fused_attention.py
// (host side `_fused_backward`, pallas_call at :434), together with the row
// statistic delta = sum_d dO * O that sav_tpu computes outside it
// (`_bwd_prep`, sav_tpu/ops/flash_attention.py). With the whole kv row of one
// batch*head slice on chip, it recomputes the probabilities from the
// forward's lse and emits dq, dk and dv:
//
//   s  = (q . k) * scale          f32 product, THEN the scale (as the forward)
//   p  = exp(s - lse)
//   dp = dO . v                   f32
//   ds = p * (dp - delta)
//   dq = (ds -> k dtype) . k * scale
//   dv = sum over q rows of (p -> dO dtype)^T dO
//   dk = sum over q rows of (ds -> q dtype)^T q * scale
//
// The roundings to the input dtype sit where the TPU kernel casts before
// each product, so bf16 gradients round as sav_tpu's do. Products
// accumulate in f32.
//
// What bounds it on the H100: at the DeiT-S train shape (B=256, L=197, H=6,
// D=64, bf16) the function moves ~311 MB (q, k, v, o, dO and the lse in;
// dq, dk, dv out) and does ~38 GFLOP (five products of 2*B*H*L*L*D), so the
// card's floor is memory: ~0.09 ms at 3.35 TB/s.
//
// Two variants, chosen by the C entry point by dtype and head dim
// (`sav_fused_attention_bwd_variant`), both counted as one launch of this
// kernel:
//
// - bf16 at D <= 128: tensor cores (`fused_attention_bwd_mma_kernel`).
//   Every product is warp-level mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators; mma_tiles.cuh): at L=197 wgmma's 64-row granularity would
//   waste much of each tile, m16n8k16 wastes 5 % (197 -> 208 rows). One
//   block per batch*head slice; the slice's whole K and V sit in shared
//   memory as bf16 (rows padded to 16, zero-filled), q and dO stream
//   through a two-stage cp.async ring in tiles of 32 rows. Each warp owns
//   16 kv rows (16 warps at head dims up to 64, 8 above) and, per q tile,
//   forms S^T and dP^T for them from the same K/V fragments, then
//   P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta), and
//   accumulates dV += P^T dO and dK += dS^T Q in registers for the whole
//   sweep: the f32 dK/dV never touch shared memory. dS^T, rounded to bf16,
//   goes to shared memory, and after a barrier dQ = dS K * scale for the
//   tile is a second product over the kv rows, one warp per 16 x 8 output
//   tile. Where the kv rows outnumber the warps' 16 each, the block sweeps
//   the q tiles once per round of kv rows, and dQ's f32 partial sums wait
//   in a device scratch row owned by the same thread in every round.
//   delta = dO . O and the lse of every q row of the slice go to shared
//   memory once, while K and V are in flight. The softmax is one ex2 per
//   score (scale and lse in base 2). It is not the bytes that bound this
//   variant (it takes ~6x the floor above): one 16-warp block per SM, with
//   two barriers per q tile, runs its copies, products and exps one after
//   the other and no second block overlaps them; wgmma with producer and
//   consumer warps is the next design.
// - f32, and bf16 at D > 128: CUDA cores (`fused_attention_bwd_kernel`),
//   exact f32 products (no TF32: the f32 checks hold 2e-5). Per tile of
//   kWarps * R query rows: (1) each warp loads its R rows of q and dO
//   widened to f32 and forms delta; lanes stride over the kv columns
//   computing s and dp from the same K/V chunks (K and V copied once into
//   shared memory, rows padded by 16 bytes against bank conflicts), and
//   write the rounded p and ds rows to shared memory; (2) each warp forms dq
//   for its rows; (3) after a block barrier, each warp adds the tile's
//   contribution to the f32 dk/dv in shared memory for its groups of 4 kv
//   rows. R (4, 2 or 1) is the largest whose shared memory fits in 227 KB.
//   Bound by issued FMA and shared-memory instructions.
//
// Both: Hopper runs blocks in no order, so the TPU kernel's sequential
// sweep over q blocks (dk/dv carried in VMEM scratch from one grid step to
// the next) becomes a loop inside the block. Each dk/dv/dq element has one
// owner and its terms are added in a fixed order: no atomics, so the
// gradients are deterministic. q/k/v/o/dO are read strided in their
// [B, L, H, D] layout (unit stride on D) and dq/dk/dv written the same way;
// rows past Lq and columns past Lk add nothing (p = 0 there). The Python
// eligibility rule mirrors `smem_bytes`, `pick_rows`, `mma_smem_bytes` and
// `mma_rounds`.

#include <math.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 256;              // largest head dim
constexpr int kMaxPairs = kMaxDim / 64;   // output column pairs per lane
constexpr int kSmemLimit = 232448;        // dynamic shared memory per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Lq], contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dq_acc;  // f32 [B*H, Lq, D] partial dq; only with mma_rounds > 1
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};

// Dynamic shared memory of one block with `rows` query rows per warp: K and
// V (rows padded by 16 bytes), f32 dK and dV, and for the tile of
// kWarps * rows query rows its f32 q and dO rows and its f32 p and ds rows.
__host__ __device__ inline size_t smem_bytes(int lk, int d, int itemsize,
                                             int rows) {
  const int vec = 16 / itemsize;
  const int tile = kWarps * rows;
  return (size_t)2 * lk * (d + vec) * itemsize +
         (size_t)2 * lk * d * sizeof(float) +
         (size_t)2 * tile * d * sizeof(float) +
         (size_t)2 * tile * round_up4(lk) * sizeof(float);
}

// Query rows per warp: the largest of 4, 2, 1 that fits; 0 if none does.
inline int pick_rows(int lk, int d, int itemsize) {
  for (int rows = 4; rows >= 1; rows >>= 1)
    if (smem_bytes(lk, d, itemsize, rows) <= (size_t)kSmemLimit) return rows;
  return 0;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int kTile = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lq = p.Lq;
  const int Lk = p.Lk;
  const int chunks = D / V;        // 16-byte chunks per row
  const int kstride = D + V;       // padded K/V row, in elements
  const int pstride = round_up4(Lk);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Lk * kstride;
  float* dks = reinterpret_cast<float*>(vs + (size_t)Lk * kstride);
  float* dvs = dks + (size_t)Lk * D;
  float* qt = dvs + (size_t)Lk * D;
  float* dot = qt + kTile * D;
  float* pt = dot + kTile * D;
  float* dst = pt + (size_t)kTile * pstride;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. The slice's K and V into shared memory; dK, dV and the tile's pad
  //    columns (read by the float4 sweeps of step 4) to zero.
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  for (int i = tid; i < Lk * chunks; i += kThreads) {
    const int j = i / chunks;
    const int c = i - j * chunks;
    const uint4 kk = *reinterpret_cast<const uint4*>(kg + j * p.sk[1] + c * V);
    const uint4 vv = *reinterpret_cast<const uint4*>(vg + j * p.sv[1] + c * V);
    *reinterpret_cast<uint4*>(ks + (size_t)j * kstride + c * V) = kk;
    *reinterpret_cast<uint4*>(vs + (size_t)j * kstride + c * V) = vv;
  }
  for (int i = tid; i < 2 * Lk * D; i += kThreads) dks[i] = 0.f;
  const int pad = pstride - Lk;
  for (int i = tid; i < kTile * pad; i += kThreads) {
    const int r = i / pad;
    const int j = Lk + (i - r * pad);
    pt[r * pstride + j] = 0.f;
    dst[r * pstride + j] = 0.f;
  }
  __syncthreads();

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* og = static_cast<const T*>(p.o) + b * p.so[0] + h * p.so[2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[2];
  const float* lseg = p.lse + (size_t)bh * Lq;
  float* qw = qt + warp * R * D;
  float* dow = dot + warp * R * D;
  float* pw = pt + (size_t)warp * R * pstride;
  float* dsw = dst + (size_t)warp * R * pstride;

  for (int tile0 = 0; tile0 < Lq; tile0 += kTile) {
    const int row0 = tile0 + warp * R;
    const int nrows = max(0, min(R, Lq - row0));

    // 2. The warp's q and dO rows widened to f32 (zero past Lq), and
    //    delta = dO . O for each of them.
    float delta[R], lse[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) {
        float qv = 0.f, dov = 0.f;
        if (r < nrows) {
          const int64_t row = row0 + r;
          qv = E::load(qg + row * p.sq[1] + d);
          dov = E::load(dog + row * p.sdo[1] + d);
          part = fmaf(dov, E::load(og + row * p.so[1] + d), part);
        }
        qw[r * D + d] = qv;
        dow[r * D + d] = dov;
      }
      delta[r] = warp_sum(part);
      lse[r] = r < nrows ? lseg[row0 + r] : 0.f;
    }
    __syncwarp();

    // 3. s = (q . k) * scale and dp = dO . v, lanes striding over the kv
    //    columns; p = exp(s - lse), ds = p * (dp - delta), both rounded to
    //    the input dtype, into the tile. Rows past Lq get zeros.
    for (int j = lane; j < Lk; j += 32) {
      float as[R], ap[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        as[r] = 0.f;
        ap[r] = 0.f;
      }
      const T* krow = ks + (size_t)j * kstride;
      const T* vrow = vs + (size_t)j * kstride;
      for (int c = 0; c < chunks; ++c) {
        float kf[V], vf[V];
        E::unpack(*reinterpret_cast<const uint4*>(krow + c * V), kf);
        E::unpack(*reinterpret_cast<const uint4*>(vrow + c * V), vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qw + r * D + c * V);
          const float4* g4 = reinterpret_cast<const float4*>(dow + r * D + c * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 x = q4[e];
            const float4 y = g4[e];
            as[r] = fmaf(x.x, kf[4 * e], as[r]);
            as[r] = fmaf(x.y, kf[4 * e + 1], as[r]);
            as[r] = fmaf(x.z, kf[4 * e + 2], as[r]);
            as[r] = fmaf(x.w, kf[4 * e + 3], as[r]);
            ap[r] = fmaf(y.x, vf[4 * e], ap[r]);
            ap[r] = fmaf(y.y, vf[4 * e + 1], ap[r]);
            ap[r] = fmaf(y.z, vf[4 * e + 2], ap[r]);
            ap[r] = fmaf(y.w, vf[4 * e + 3], ap[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float pr = 0.f, dsr = 0.f;
        if (r < nrows) {
          pr = expf(as[r] * p.scale - lse[r]);
          dsr = pr * (ap[r] - delta[r]);
        }
        pw[r * pstride + j] = E::round(pr);
        dsw[r * pstride + j] = E::round(dsr);
      }
    }
    __syncwarp();  // step 4 reads every lane's ds

    // 4. dq = ds . k * scale for the warp's rows; lane owns the column pairs
    //    d = 2 * lane + 64 * u.
    float2 acc[R][kMaxPairs];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) acc[r][u] = make_float2(0.f, 0.f);
    int j = 0;
    for (; j + 4 <= Lk; j += 4) {
      float4 sr[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sr[r] = *reinterpret_cast<const float4*>(dsw + r * pstride + j);
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 k0 = E::load2(ks + (size_t)(j + 0) * kstride + d);
          const float2 k1 = E::load2(ks + (size_t)(j + 1) * kstride + d);
          const float2 k2 = E::load2(ks + (size_t)(j + 2) * kstride + d);
          const float2 k3 = E::load2(ks + (size_t)(j + 3) * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float2 a = acc[r][u];
            a.x = fmaf(sr[r].x, k0.x, a.x);
            a.y = fmaf(sr[r].x, k0.y, a.y);
            a.x = fmaf(sr[r].y, k1.x, a.x);
            a.y = fmaf(sr[r].y, k1.y, a.y);
            a.x = fmaf(sr[r].z, k2.x, a.x);
            a.y = fmaf(sr[r].z, k2.y, a.y);
            a.x = fmaf(sr[r].w, k3.x, a.x);
            a.y = fmaf(sr[r].w, k3.y, a.y);
            acc[r][u] = a;
          }
        }
      }
    }
    for (; j < Lk; ++j) {
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 kk = E::load2(ks + (size_t)j * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float sj = dsw[r * pstride + j];
            acc[r][u].x = fmaf(sj, kk.x, acc[r][u].x);
            acc[r][u].y = fmaf(sj, kk.y, acc[r][u].y);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        T* dqrow = dqg + (int64_t)(row0 + r) * p.sdq[1];
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            E::store(dqrow + d, acc[r][u].x * p.scale);
            E::store(dqrow + d + 1, acc[r][u].y * p.scale);
          }
        }
      }
    }
    __syncthreads();  // the whole tile's p, ds, q and dO are in place

    // 5. dv += p^T . dO and dk += ds^T . q over the tile's rows, in row
    //    order; warp w owns the kv rows 4g..4g+3 for g = w, w + kWarps, ...
    const int tile_rows = min(kTile, Lq - tile0);
    for (int j0 = 4 * warp; j0 < Lk; j0 += 4 * kWarps) {
      float2 adv[4][kMaxPairs], adk[4][kMaxPairs];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          adv[jj][u] = make_float2(0.f, 0.f);
          adk[jj][u] = make_float2(0.f, 0.f);
        }
      for (int i = 0; i < tile_rows; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + (size_t)i * pstride + j0);
        const float4 s4 = *reinterpret_cast<const float4*>(dst + (size_t)i * pstride + j0);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            const float2 g2 = *reinterpret_cast<const float2*>(dot + i * D + d);
            const float2 q2 = *reinterpret_cast<const float2*>(qt + i * D + d);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              adv[jj][u].x = fmaf(pv[jj], g2.x, adv[jj][u].x);
              adv[jj][u].y = fmaf(pv[jj], g2.y, adv[jj][u].y);
              adk[jj][u].x = fmaf(sv[jj], q2.x, adk[jj][u].x);
              adk[jj][u].y = fmaf(sv[jj], q2.y, adk[jj][u].y);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jr = j0 + jj;
        if (jr < Lk) {
#pragma unroll
          for (int u = 0; u < kMaxPairs; ++u) {
            const int d = 2 * lane + 64 * u;
            if (d < D) {
              float2* vrow = reinterpret_cast<float2*>(dvs + (size_t)jr * D + d);
              float2* krow = reinterpret_cast<float2*>(dks + (size_t)jr * D + d);
              float2 a = *vrow;
              a.x += adv[jj][u].x;
              a.y += adv[jj][u].y;
              *vrow = a;
              float2 c = *krow;
              c.x += adk[jj][u].x;
              c.y += adk[jj][u].y;
              *krow = c;
            }
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites q, dO, p and ds
  }

  // 6. dk = dK * scale and dv = dV, in the input dtype.
  T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[2];
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[2];
  for (int i = tid; i < Lk * D; i += kThreads) {
    const int j = i / D;
    const int d = i - j * D;
    E::store(dkg + j * p.sdk[1] + d, dks[i] * p.scale);
    E::store(dvg + j * p.sdv[1] + d, dvs[i]);
  }
}

template <typename T, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, p.D, (int)sizeof(T), R);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_bwd_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_bwd_kernel<T, R><<<p.B * p.H, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

constexpr int kMq = 32;          // q rows per tile
constexpr int kMmaMaxDim = 128;  // largest head dim of the bf16 variant

// Warps of a bf16 block, each owning 16 kv rows: 16 up to head dim 64
// (2 x 32 f32 accumulator registers for dK/dV), 8 above.
__host__ __device__ inline int mma_warps(int d) {
  return round_up16(d) <= 64 ? 16 : 8;
}

// Rounds of kv rows a bf16 block sweeps the q tiles for.
__host__ __device__ inline int mma_rounds(int lk, int d) {
  const int rows = 16 * mma_warps(d);
  return (round_up16(lk) + rows - 1) / rows;
}

// q rows of a slice rounded up to whole tiles.
__host__ __device__ inline int mma_q_rows(int lq) {
  return (lq + kMq - 1) / kMq * kMq;
}

// Dynamic shared memory of one bf16 block: K and V of the slice, two
// stages of q and dO tiles (bf16 rows of round_up16(d) + 8), the round's
// dS^T tile, and the lse and delta of every q row of the slice.
__host__ __device__ inline size_t mma_smem_bytes(int lq, int lk, int d) {
  const size_t ld = round_up16(d) + 8;
  return 2 * (size_t)round_up16(lk) * ld * sizeof(bf16) +
         4 * (size_t)kMq * ld * sizeof(bf16) +
         (size_t)16 * mma_warps(d) * (kMq + 8) * sizeof(bf16) +
         2 * (size_t)mma_q_rows(lq) * sizeof(float);
}

template <int DK, int W>
__global__ void __launch_bounds__(W * 32, 1)
    fused_attention_bwd_mma_kernel(const Params p) {
  constexpr int kThreadCount = W * 32;
  constexpr int LD = DK + 8;        // bf16 row stride of K, V, q and dO
  constexpr int LDS = kMq + 8;      // bf16 row stride of the dS^T tile
  constexpr int NT = DK / 8;        // 8-column tiles over the head dim
  constexpr int KS = DK / 16;       // k-steps over the head dim
  constexpr int QT = kMq / 8;       // 8-column tiles over a q tile
  constexpr int RROWS = 16 * W;     // kv rows of one round
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int D = p.D;
  const int Lq = p.Lq;
  const int Lk = p.Lk;
  const int Lkp = round_up16(Lk);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Lkp * LD;
  bf16* qts = vs + Lkp * LD;         // [2][kMq][LD]
  bf16* dots = qts + 2 * kMq * LD;   // [2][kMq][LD]
  bf16* dss = dots + 2 * kMq * LD;   // [RROWS][LDS], rows kv, columns q
  float* lse_s = reinterpret_cast<float*>(dss + RROWS * LDS);  // log2 units
  float* delta_s = lse_s + mma_q_rows(Lq);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const bf16* og = static_cast<const bf16*>(p.o) + b * p.so[0] + h * p.so[2];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq[0] + h * p.sdq[2];
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk[0] + h * p.sdk[2];
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv[0] + h * p.sdv[2];
  const float* lseg = p.lse + (size_t)bh * Lq;

  const int ntq = (Lq + kMq - 1) / kMq;
  const int rounds = (Lkp + RROWS - 1) / RROWS;
  const int iters = rounds * ntq;

  // The slice's K and V, and the first q and dO tiles.
  load_tile_async<kThreadCount>(ks, LD, kg, p.sk[1], Lkp, Lk, DK, D);
  load_tile_async<kThreadCount>(vs, LD, vg, p.sv[1], Lkp, Lk, DK, D);
  load_tile_async<kThreadCount>(qts, LD, qg, p.sq[1], kMq, min(kMq, Lq), DK,
                                D);
  load_tile_async<kThreadCount>(dots, LD, dog, p.sdo[1], kMq, min(kMq, Lq),
                                DK, D);
  cp_async_commit();

  // While those land: delta = dO . O of every q row of the slice, and its
  // lse in base 2; past Lq, lse = +inf makes p = 0.
  const float scale2 = p.scale * kLog2e;
#pragma unroll 4
  for (int r = warp; r < ntq * kMq; r += W) {
    float part = 0.f;
    if (r < Lq) {
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 x = Elem<bf16>::load2(dog + (int64_t)r * p.sdo[1] + d);
        const float2 y = Elem<bf16>::load2(og + (int64_t)r * p.so[1] + d);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = r < Lq ? lseg[r] * kLog2e : INFINITY;
    }
  }

  float dk_acc[NT][4], dv_acc[NT][4];
  for (int it = 0; it < iters; ++it) {
    const int round = it / ntq;
    const int tq = it - round * ntq;
    const int q0 = tq * kMq;
    const int nq = min(kMq, Lq - q0);
    const int stage = it & 1;
    const int kv0 = round * RROWS + warp * 16;  // the warp's kv rows
    const bool active = kv0 < Lk;
    const int groups = min(W, (Lkp - round * RROWS) / 16);  // active warps
    if (tq == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
    }

    if (it + 1 < iters) {
      const int qn = (it + 1 - (it + 1) / ntq * ntq) * kMq;
      const int nn = min(kMq, Lq - qn);
      const int next = (stage ^ 1) * kMq * LD;
      load_tile_async<kThreadCount>(qts + next, LD, qg + (int64_t)qn * p.sq[1],
                                    p.sq[1], kMq, nn, DK, D);
      load_tile_async<kThreadCount>(dots + next, LD,
                                    dog + (int64_t)qn * p.sdo[1], p.sdo[1],
                                    kMq, nn, DK, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K/V) have landed
    __syncthreads();     // ... for every thread, with lse and delta

    const bf16* qt = qts + stage * kMq * LD;
    const bf16* dt = dots + stage * kMq * LD;
    if (active) {
      // S^T = K_w . Q^T and dP^T = V_w . dO^T: 16 kv rows x 32 q columns.
      float st[QT][4], dpt[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4];
        load_a(ka, ks + kv0 * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < QT / 2; ++jp) {
          uint32_t qb[4];
          load_b2(qb, qt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(st[2 * jp], ka, qb[0], qb[1]);
          mma_bf16(st[2 * jp + 1], ka, qb[2], qb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t va[4];
        load_a(va, vs + kv0 * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < QT / 2; ++jp) {
          uint32_t gb[4];
          load_b2(gb, dt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(dpt[2 * jp], va, gb[0], gb[1]);
          mma_bf16(dpt[2 * jp + 1], va, gb[2], gb[3]);
        }
      }
      // P^T = exp(s * scale - lse), as one ex2 in base 2, and dS^T, in
      // f32; kv rows past Lk give nothing.
#pragma unroll
      for (int j = 0; j < QT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = kv0 + g + 8 * (e >> 1);
          const int c = q0 + j * 8 + 2 * t4 + (e & 1);
          float pr = 0.f, ds = 0.f;
          if (kv < Lk) {
            pr = exp2_approx(fmaf(st[j][e], scale2, -lse_s[c]));
            ds = pr * (dpt[j][e] - delta_s[c]);
          }
          st[j][e] = pr;
          dpt[j][e] = ds;
        }
      }
      // dV += (P^T -> bf16) . dO and dK += (dS^T -> bf16) . Q over the
      // tile's q rows, 16 per k-step.
#pragma unroll
      for (int kk = 0; kk < QT / 2; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t gb[4];
          load_b2_trans(gb, dt + (kk * 16) * LD + jp * 16, LD, lane);
          mma_bf16(dv_acc[2 * jp], pa, gb[0], gb[1]);
          mma_bf16(dv_acc[2 * jp + 1], pa, gb[2], gb[3]);
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t qb[4];
          load_b2_trans(qb, qt + (kk * 16) * LD + jp * 16, LD, lane);
          mma_bf16(dk_acc[2 * jp], sa, qb[0], qb[1]);
          mma_bf16(dk_acc[2 * jp + 1], sa, qb[2], qb[3]);
        }
      }
      // dS^T rounded to bf16 (the k dtype) for dQ.
      bf16* drow = dss + (warp * 16 + g) * LDS + 2 * t4;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        *reinterpret_cast<uint32_t*>(drow + j * 8) =
            pack_bf16(dpt[j][0], dpt[j][1]);
        *reinterpret_cast<uint32_t*>(drow + 8 * LDS + j * 8) =
            pack_bf16(dpt[j][2], dpt[j][3]);
      }
    }
    __syncthreads();  // the round's dS^T tile is complete

    // dQ of the tile over the round's kv rows: one warp per 16 x 8 output
    // tile, the even and the odd 16-row kv groups in two chains (half the
    // dependent latency), each in kv order, added last.
    for (int u = warp; u < 2 * NT; u += W) {
      const int mt = u / NT;
      const int nt = u - mt * NT;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float acc1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kg16 = 0; kg16 < groups; kg16 += 2) {
        uint32_t a[4], kb[2];
        load_a_trans(a, dss + (kg16 * 16) * LDS + mt * 16, LDS, lane);
        load_b1_trans(kb, ks + (round * RROWS + kg16 * 16) * LD + nt * 8, LD,
                      lane);
        mma_bf16(acc, a, kb[0], kb[1]);
        if (kg16 + 1 < groups) {
          load_a_trans(a, dss + (kg16 * 16 + 16) * LDS + mt * 16, LDS, lane);
          load_b1_trans(kb, ks + (round * RROWS + kg16 * 16 + 16) * LD + nt * 8,
                        LD, lane);
          mma_bf16(acc1, a, kb[0], kb[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += acc1[e];
      const int c = nt * 8 + 2 * t4;
      if (c >= D) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + g + 8 * i;
        if (r >= nq) continue;
        const int64_t row = q0 + r;
        float x0 = acc[2 * i], x1 = acc[2 * i + 1];
        if (rounds > 1) {
          float* partial = p.dq_acc + ((size_t)bh * Lq + row) * D + c;
          if (round > 0) {
            x0 += partial[0];
            x1 += partial[1];
          }
          if (round + 1 < rounds) {
            partial[0] = x0;
            partial[1] = x1;
            continue;
          }
        }
        *reinterpret_cast<uint32_t*>(dqg + row * p.sdq[1] + c) =
            pack_bf16(x0 * p.scale, x1 * p.scale);
      }
    }

    // After the round's last q tile: the warp's dK * scale and dV.
    if (tq == ntq - 1 && active) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kv = kv0 + g + 8 * i;
          if (kv < Lk && c < D) {
            *reinterpret_cast<uint32_t*>(dkg + kv * p.sdk[1] + c) = pack_bf16(
                dk_acc[j][2 * i] * p.scale, dk_acc[j][2 * i + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvg + kv * p.sdv[1] + c) =
                pack_bf16(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
          }
        }
      }
    }
  }
}

template <int DK, int W>
int launch_mma_dk(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.Lq, p.Lk, p.D);
  if (smem > (size_t)kSmemLimit ||
      (mma_rounds(p.Lk, p.D) > 1 && p.dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_bwd_mma_kernel<DK, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_bwd_mma_kernel<DK, W>
      <<<p.B * p.H, W * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const Params& p, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_dk<16, 16>(p, stream);
    case 2: return launch_mma_dk<32, 16>(p, stream);
    case 3: return launch_mma_dk<48, 16>(p, stream);
    case 4: return launch_mma_dk<64, 16>(p, stream);
    case 5: return launch_mma_dk<80, 8>(p, stream);
    case 6: return launch_mma_dk<96, 8>(p, stream);
    case 7: return launch_mma_dk<112, 8>(p, stream);
    case 8: return launch_mma_dk<128, 8>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The variant a launch takes: 1 = tensor cores (bf16, D <= 128), 0 = CUDA
// cores (f32, and bf16 at D > 128).
int variant(int dtype, int d) { return dtype == 1 && d <= kMmaMaxDim ? 1 : 0; }

// ---- f32 (and bf16 at D > 128) on the CUDA cores ----

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  switch (pick_rows(p.Lk, p.D, (int)sizeof(T))) {
    case 4:
      return launch_rows<T, 4>(p, stream);
    case 2:
      return launch_rows<T, 2>(p, stream);
    case 1:
      return launch_rows<T, 1>(p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at `rows` query rows per warp, and the
// rows the launcher picks (0: the shape does not fit). The Python
// eligibility rule mirrors both.
size_t sav_fused_attention_bwd_smem_bytes(int lk, int d, int itemsize,
                                          int rows) {
  return smem_bytes(lk, d, itemsize, rows);
}

int sav_fused_attention_bwd_rows(int lk, int d, int itemsize) {
  return pick_rows(lk, d, itemsize);
}

// The variant of a launch (1: bf16 on the tensor cores, 0: CUDA cores), and
// the bf16 variant's shared-memory bytes and rounds of kv rows (more than
// one needs the f32 dq scratch).
int sav_fused_attention_bwd_variant(int dtype, int d) {
  return variant(dtype, d);
}

size_t sav_fused_attention_bwd_mma_smem_bytes(int lq, int lk, int d) {
  return mma_smem_bytes(lq, lk, d);
}

int sav_fused_attention_bwd_mma_rounds(int lk, int d) {
  return mma_rounds(lk, d);
}

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, in order
// q, k, v, o, dO, dq, dk, dv, each (b, l, h). lse: [B, H, Lq] f32. dq_acc:
// f32 scratch of B*H*Lq*D, needed by the bf16 variant when
// sav_fused_attention_bwd_mma_rounds > 1, else may be null.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_fused_attention_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            float* dq_acc, int B, int H, int Lq, int Lk, int D,
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
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dq_acc = dq_acc;
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
    p.sdo[i] = strides[12 + i];
    p.sdq[i] = strides[15 + i];
    p.sdk[i] = strides[18 + i];
    p.sdv[i] = strides[21 + i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(dtype, D) == 1) return launch_mma(p, s);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
