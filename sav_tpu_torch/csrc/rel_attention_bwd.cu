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
// L=196 (B=256, H=4, D=128, bf16) dq moves ~258 MB (q, k, v, dO, the compact
// logits, lse and delta in; dq, d_rw, d_rh out) and does three products,
// ~30 GFLOP; dk/dv moves ~284 MB and does four, ~40 GFLOP: both floors are
// the bytes, ~0.08 ms. These kernels do not reach them: every product runs
// on the CUDA cores in f32, as in the flash backward they extend. That is
// deliberate for first kernels that must be right; mma/wgmma tiles are
// later work.
//
// Design (tile pieces in flash_tiles.cuh):
// - dq: one block per (batch*head slice, 64-row q tile) loops over the kv
//   tiles. q, dO and the tile's rw/rh rows stay in shared memory, k and v
//   stream. Each ds tile is written to shared memory in f32; the block then
//   reduces its rows into f32 accumulators d_rw[r][kw] and d_rh[r][kh] in
//   shared memory, each owned by one thread for the whole sweep and summed
//   over the tile's columns in a fixed order (kw: columns kw, kw + W, ...;
//   kh: the W contiguous columns of that key row), then rounds ds to the k
//   dtype in place for the dq product. d_rw/d_rh are written once at the
//   end, dq from registers.
// - dk/dv: one block per (batch*head slice, 64-row kv tile) loops over the q
//   tiles, computing the transposed scores (kv rows by q columns). The key
//   coordinates (kh, kw) of its kv rows are fixed for the block; for each q
//   tile it loads that tile's rw/rh rows with q, dO, lse and delta.
// - Every output element has one owner, summed in a fixed order: no
//   atomics, the same bits on every run.
// - L = 49 is shorter than one tile: p is zero on rows and columns past L,
//   so padded query rows add nothing to dk, dv, d_rw or d_rh; padded kv rows
//   of the dk/dv block are computed and not stored.
// - The (kh, kw) of a column are one division by W per column per tile,
//   outside the row loops.

#include <math.h>

#include "flash_tiles.cuh"

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

// Dynamic shared memory of one block (rel = W + Hg). dq: f32 q, dO, k and v
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
// rel = W + Hg; the Python eligibility rule mirrors both.
size_t sav_rel_attention_bwd_dq_smem_bytes(int d, int rel) {
  return dq_smem_bytes(d, rel);
}
size_t sav_rel_attention_bwd_dkv_smem_bytes(int d, int rel) {
  return dkv_smem_bytes(d, rel);
}

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
  if (dtype == 1)
    return D <= 64 ? launch_dq<__nv_bfloat16, 1>(p, s)
                   : launch_dq<__nv_bfloat16, 2>(p, s);
  return D <= 64 ? launch_dq<float, 1>(p, s) : launch_dq<float, 2>(p, s);
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
  if (dtype == 1)
    return D <= 64 ? launch_dkv<__nv_bfloat16, 1>(p, s)
                   : launch_dkv<__nv_bfloat16, 2>(p, s);
  return D <= 64 ? launch_dkv<float, 1>(p, s) : launch_dkv<float, 2>(p, s);
}

}  // extern "C"
