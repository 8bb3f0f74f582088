// BoTNet 2-D relative-position flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rel_kernel` in sav_tpu/ops/flash_attention.py
// (:663, host side `_rel_forward`, pallas_call at :777). It is the flash
// forward (flash_attention.cu, `_kernel`) with the relative-position bias
// built inside the kernel from the compact absolute per-axis logits
// rw_abs [B, H, L, W] and rh_abs [B, H, L, Hg] (f32), L = Hg * W:
//
//   s      = (q . k) * scale             f32 product, THEN the scale
//   s     += rw_abs[q, kw] + rh_abs[q, kh],   key column c = kh * W + kw
//   s      = -inf on padded key columns (the last tile only)
//   m_new  = max(m, rowmax(s));  alpha = exp(m - m_new)
//   p      = exp(s - m_new)               unnormalised
//   l      = alpha * l + rowsum(p)
//   acc    = alpha * acc + (p -> v dtype) . v
//   o      = acc / l on the last tile, then cast; lse = m + log l
//
// in `_rel_kernel`'s order (scale, bias, mask) and with
// `_online_softmax_step`'s roundings. The [B, H, L, L] bias and scores never
// reach device memory.
//
// What bounds it on the H100: at BoTNet-T3's stage-4 train shapes (B=256,
// H=4, D=128, bf16) the function moves ~229 MB at L=196 (q, k, v, o, the
// compact logits and the lse, once each) and ~54 MB at L=49, and does ~20
// and ~1.3 GFLOP: the card's floor is the bytes, ~0.07 and ~0.016 ms.
//
// Two variants, chosen by the C entry point by dtype
// (`sav_rel_attention_variant`), both counted as one launch of this kernel.
// In both, the q tile's rows of rw_abs (W f32 each) and rh_abs (Hg f32
// each) are loaded into shared memory once (rows past L are zero) and read
// for every kv tile; the band of (D, W + Hg) that fits is `rel_eligible` in
// ops/flash_attention.py. L = 49 is shorter than one kv tile: the padded
// columns are -inf in the scores, so they add exact zeros to l and acc;
// padded query rows compute on zero q rows and zero bias and are not
// stored. q/k/v/o are read and written strided in their [B, L, H, D]
// layout (unit stride on D, 16-byte aligned rows).
//
// - bf16: tensor cores (`rel_attention_fwd_mma_kernel`), the flash
//   forward's bf16 variant (flash_attention.cu) with the bias built in:
//   both products are warp-level mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators; mma_tiles.cuh), each warp owning 16 query rows. A block
//   owns 128 query rows (8 warps) where L > 64, and 64 (4 warps) where L
//   fits one kv tile: at L = 49 a 128-row block would leave 79 of its rows
//   idle. K/V tiles of 64 rows stream through a two-stage cp.async ring;
//   the kv tile stays 64, so the bf16 bits follow
//   rel_attention_reference(block_kv=64). The q tile's rows of the compact
//   logits come by 4-byte cp.async in the first copy group, beside the q
//   tile and the first K/V tiles: loaded through registers, they held
//   every warp before its first tile. S stays in registers; each thread
//   adds the bias at its own accumulator positions (rows g and g + 8,
//   columns 2t and 2t + 1 of each 8-column tile), after the scale, in base
//   2; the key coordinates (kh, kw) of the tile's 64 columns are one
//   division by W per column per kv tile, made while the tile is copied and
//   kept in shared memory. The online softmax (m, l, alpha) runs on the
//   accumulator rows with quad shuffles and one ex2 a score; p, rounded to
//   bf16, becomes the A operand of P.V straight from the accumulators.
// - f32: CUDA cores (`rel_attention_fwd_kernel`), exact f32 products, no
//   TF32 (tile pieces in flash_tiles.cuh, as the flash forward's f32
//   variant): one block per (batch*head slice, tile of 64 query rows), 256
//   threads as 16 x 16 with a 4 x 4 micro-tile each; K and V stream through
//   shared memory 64 rows at a time, widened to f32; the key coordinates of
//   a thread's four columns are one integer division by W per column per
//   kv tile. Bound by issued FMA and shared-memory instructions.

#include <math.h>

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* rw;  // [B, H, L, W], contiguous
  const float* rh;  // [B, H, L, Hg], contiguous
  void* o;
  float* lse;  // [B, H, L], contiguous
  int B, H, L, D, Hg, W;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3];
  float scale;
};

// Dynamic shared memory of one block: f32 q, k and v tiles, the p tile and
// the q tile's rw/rh rows (rel = W + Hg).
__host__ __device__ inline size_t smem_bytes(int d, int rel) {
  return 3 * tile_bytes(d) + score_bytes() + rel_rows_bytes(rel);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    rel_attention_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int W = p.W;
  const int Hg = p.Hg;
  float* qs = smem;
  float* ks = qs + kTile * tile_ld(D);
  float* vs = ks + kTile * tile_ld(D);
  float* ps = vs + kTile * tile_ld(D);
  float* rws = ps + kTile * kLdS;  // [64][W]
  float* rhs = rws + kTile * W;    // [64][Hg]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int nq = min(kTile, p.L - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2] +
                (int64_t)q0 * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const size_t row0 = (size_t)bh * p.L + q0;
  load_tile<T>(qs, qg, p.sq[1], nq, D);
  load_rows_f32(rws, p.rw + row0 * W, kTile * W, nq * W);
  load_rows_f32(rhs, p.rh + row0 * Hg, kTile * Hg, nq * Hg);

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.L; k0 += kTile) {
    const int nk = min(kTile, p.L - k0);
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<T>(ks, kg + (int64_t)k0 * p.sk[1], p.sk[1], nk, D);
    load_tile<T>(vs, vg + (int64_t)k0 * p.sv[1], p.sv[1], nk, D);
    __syncthreads();

    // Key coordinates of this thread's four columns (any valid value past
    // L: those columns are masked).
    int kh[4], kw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = c < nk ? k0 + c : 0;
      kh[j] = col / W;
      kw[j] = col - kh[j] * W;
    }

    float s[4][4];
    tile_dot(qs, ks, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * p.scale;
        x += rws[r * W + kw[j]] + rhs[r * Hg + kh[j]];
        if (c >= nk) x = -INFINITY;  // padded kv columns, last tile only
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        ps[r * kLdS + tx + 16 * j] = Elem<T>::round(e);
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        acc[i][u].x *= alpha;
        acc[i][u].y *= alpha;
        acc[i][u].z *= alpha;
        acc[i][u].w *= alpha;
      }
    }
    __syncthreads();  // every thread's p is in place
    tile_pv<NU>(ps, vs, D, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      acc[i][u].x /= l[i];
      acc[i][u].y /= l[i];
      acc[i][u].z /= l[i];
      acc[i][u].w /= l[i];
    }
    const int r = 4 * ty + i;
    if (tx == 0 && r < nq) p.lse[row0 + r] = m[i] + logf(l[i]);
  }
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2] +
          (int64_t)q0 * p.so[1];
  store_tile<T, NU>(og, p.so[1], nq, D, ty, tx, acc, 1.f);
}

template <typename T, int NU>
int launch_nu(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.W + p.Hg);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.L + kTile - 1) / kTile);
  rel_attention_fwd_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch_nu<T, 1>(p, stream) : launch_nu<T, 2>(p, stream);
}

// ---- bf16 on the tensor cores ----

// Query rows of one bf16 block: 128 (8 warps of 16 rows) where L is longer
// than one kv tile, 64 (4 warps) where it is not.
__host__ __device__ inline int mma_rows(int L) { return L > kTile ? 128 : 64; }

// Dynamic shared memory of one bf16 block at head dim d on an hg x w grid:
// the q tile and a two-stage ring of k and v tiles, bf16 rows of
// round_up16(d) + 8; the q tile's f32 rows of rw_abs and rh_abs; the key
// coordinates of two kv tiles.
__host__ __device__ inline size_t mma_smem_bytes(int d, int hg, int w) {
  const int rows = mma_rows(hg * w);
  return (size_t)(rows + 4 * kTile) * (round_up16(d) + 8) * sizeof(bf16) +
         (size_t)rows * (hg + w) * sizeof(float) + 2 * kTile * sizeof(int);
}

template <int DK, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    rel_attention_fwd_mma_kernel(const Params p) {
  constexpr int kThreadCount = WARPS * 32;
  constexpr int kRowsBlk = 16 * WARPS;
  constexpr int LD = DK + 8;      // bf16 row stride of every tile
  constexpr int NT = DK / 8;      // 8-column tiles of the output
  constexpr int KS = DK / 16;     // k-steps of Q.K^T
  constexpr int ST = kTile / 8;   // 8-column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int L = p.L;
  const int W = p.W;
  const int Hg = p.Hg;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRowsBlk * LD;   // [2][kTile][LD]
  bf16* vs = ks + 2 * kTile * LD;  // [2][kTile][LD]
  float* rws = reinterpret_cast<float*>(vs + 2 * kTile * LD);  // [rows][W]
  float* rhs = rws + kRowsBlk * W;                               // [rows][Hg]
  int* kcs = reinterpret_cast<int*>(rhs + kRowsBlk * Hg);        // [2][kTile]

  // One block per (slice, q tile), the q tiles of a slice adjacent, so its
  // K/V are read from device memory once and then from L2.
  const int qtiles = (L + kRowsBlk - 1) / kRowsBlk;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kRowsBlk;
  const int nq = min(kRowsBlk, L - q0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the q tile
  const bool active = wrow < nq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] +
                   h * p.sq[2] + (int64_t)q0 * p.sq[1];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const size_t row0 = (size_t)bh * L + q0;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile_async<kThreadCount>(qs, LD, qg, p.sq[1], kRowsBlk, nq, DK, D);
  load_tile_async<kThreadCount>(ks, LD, kg, p.sk[1], kTile, min(kTile, L),
                                DK, D);
  load_tile_async<kThreadCount>(vs, LD, vg, p.sv[1], kTile, min(kTile, L),
                                DK, D);
  // The q tile's rows of the compact logits join the first group (zero past
  // L): copied, not loaded through registers, so that no thread waits on
  // them before the first tile.
  for (int i = tid; i < kRowsBlk * W; i += kThreadCount)
    cp_async4(rws + i, i < nq * W ? p.rw + row0 * W + i : p.rw, i < nq * W);
  for (int i = tid; i < kRowsBlk * Hg; i += kThreadCount)
    cp_async4(rhs + i, i < nq * Hg ? p.rh + row0 * Hg + i : p.rh, i < nq * Hg);
  cp_async_commit();
  if (tid < kTile) kcs[tid] = key_coord(tid, L, W);

  // Rows g and g + 8 of the warp's m-tile (index i): running max and this
  // thread's share of the running sum, both in base 2, and the f32 output
  // accumulator.
  const float scale2 = p.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float* rw_row[2] = {rws + (wrow + g) * W, rws + (wrow + g + 8) * W};
  const float* rh_row[2] = {rhs + (wrow + g) * Hg, rhs + (wrow + g + 8) * Hg};

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = (t + 1) * kTile;
      const int n1 = min(kTile, L - k1);
      bf16* kn = ks + (stage ^ 1) * kTile * LD;
      bf16* vn = vs + (stage ^ 1) * kTile * LD;
      load_tile_async<kThreadCount>(kn, LD, kg + (int64_t)k1 * p.sk[1],
                                    p.sk[1], kTile, n1, DK, D);
      load_tile_async<kThreadCount>(vn, LD, vg + (int64_t)k1 * p.sv[1],
                                    p.sv[1], kTile, n1, DK, D);
      if (tid < kTile) kcs[(stage ^ 1) * kTile + tid] = key_coord(k1 + tid, L, W);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if (active) {
      const bf16* kt = ks + stage * kTile * LD;
      const bf16* vt = vs + stage * kTile * LD;
      const int* kc = kcs + stage * kTile;
      const int nk = min(kTile, L - t * kTile);

      // S = Q . K^T for the warp's 16 rows and the tile's 64 columns.
      float s[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4];
        load_a(qf, qs + wrow * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < ST / 2; ++jp) {
          uint32_t kb[4];
          load_b2(kb, kt + (jp * 16) * LD + kk * 16, LD, lane);
          mma_bf16(s[2 * jp], qf, kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qf, kb[2], kb[3]);
        }
      }

      // The scale, then the bias rw_abs[q, kw] + rh_abs[q, kh], in base 2;
      // then the padded columns masked (the last tile only).
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const int2 cc = *reinterpret_cast<const int2*>(kc + j * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int code = (e & 1) ? cc.y : cc.x;
          const int i = e >> 1;
          const float bias = rw_row[i][code & 0xffff] + rh_row[i][code >> 16];
          float x = fmaf(bias, kLog2e, s[j][e] * scale2);
          if (j * 8 + 2 * t4 + (e & 1) >= nk) x = -INFINITY;
          s[j][e] = x;
          tmax[i] = fmaxf(tmax[i], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(tmax[i]));
        alpha[i] = exp2_approx(m[i] - m_new);  // 0 on the first tile
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp2_approx(s[j][e] - m[e >> 1]);
          sum[e >> 1] += x;
          s[j][e] = x;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + sum[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += (p -> bf16) . V: 16 kv columns per k-step, P from registers.
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t vb[4];
          load_b2_trans(vb, vt + (kk * 16) * LD + jp * 16, LD, lane);
          mma_bf16(o[2 * jp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * jp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
  bf16* og = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[2] +
             (int64_t)q0 * p.so[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    const int r = wrow + g + 8 * i;
    if (r >= nq) continue;
    if (t4 == 0) p.lse[row0 + r] = m[i] * kLn2 + logf(lsum);
    bf16* orow = og + r * p.so[1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t4;
      if (c < D)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(o[j][2 * i] / lsum, o[j][2 * i + 1] / lsum);
    }
  }
}

template <int DK, int WARPS>
int launch_mma_warps(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.D, p.Hg, p.W);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_mma_kernel<DK, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.L + 16 * WARPS - 1) / (16 * WARPS) * p.B * p.H;
  rel_attention_fwd_mma_kernel<DK, WARPS>
      <<<blocks, WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_mma_dk(const Params& p, cudaStream_t stream) {
  return mma_rows(p.L) == 128 ? launch_mma_warps<DK, 8>(p, stream)
                              : launch_mma_warps<DK, 4>(p, stream);
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

// The variant a launch takes: 1 = bf16 on the tensor cores, 0 = f32 on the
// CUDA cores; -1 for a dtype the kernel does not take.
int variant(int dtype) { return dtype == 1 ? 1 : dtype == 0 ? 0 : -1; }

}  // namespace

extern "C" {

// Shared-memory bytes one block of the variant for inputs of `itemsize`
// bytes (2: bf16, 4: f32) needs at head dim d on an hg x w grid; the Python
// eligibility rule mirrors it.
size_t sav_rel_attention_smem_bytes(int d, int hg, int w, int itemsize) {
  return itemsize == 2 ? mma_smem_bytes(d, hg, w) : smem_bytes(d, hg + w);
}

// dtype 0 = float32 -> 0 (CUDA cores), 1 = bfloat16 -> 1 (tensor cores).
int sav_rel_attention_variant(int dtype) { return variant(dtype); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in order
// q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h). rw, rh: contiguous f32
// [B, H, L, W] and [B, H, L, Hg]; lse: f32 [B, H, L].
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_rel_attention_fwd(int dtype, const void* q, const void* k,
                          const void* v, const float* rw, const float* rh,
                          void* o, float* lse, int B, int H, int L, int D,
                          int Hg, int W, const int64_t* strides, float scale,
                          void* stream) {
  if (B < 1 || H < 1 || Hg < 1 || W < 1 || L != Hg * W || D < 8 ||
      D % 8 != 0 || D > kMaxDim || (dtype != 0 && dtype != 1) || rw == nullptr ||
      rh == nullptr || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.rw = rw;
  p.rh = rh;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.L = L;
  p.D = D;
  p.Hg = Hg;
  p.W = W;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant(dtype) == 1 ? launch_mma(p, s) : launch<float>(p, s);
}

}  // extern "C"
