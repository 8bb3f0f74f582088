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
// and ~1.3 GFLOP: the card's floor is the bytes, ~0.07 and ~0.016 ms. This
// kernel does not reach it: both products run on the CUDA cores in f32, as
// in the flash forward it extends. That is deliberate for a first kernel
// that must be right; mma/wgmma tiles are later work.
//
// Design (tile pieces in flash_tiles.cuh, as the flash forward):
// - Grid: one block per (batch*head slice, tile of 64 query rows), 256
//   threads as 16 x 16 with a 4 x 4 micro-tile each. K and V stream through
//   shared memory 64 rows at a time.
// - The q tile's 64 rows of rw_abs (W f32 each) and rh_abs (Hg f32 each) are
//   loaded into shared memory once (rows past L are zero) and read for every
//   kv tile: 64 * (W + Hg) * 4 bytes, 7 KB at 14 x 14. The band of (D,
//   W + Hg) that fits is `rel_eligible` in ops/flash_attention.py.
// - The key coordinates (kh, kw) of a thread's four columns are one integer
//   division by W per column per kv tile, outside the row loop; columns past
//   L take no bias (they are masked).
// - L = 49 is shorter than one tile: the padded columns are -inf in the
//   scores, so they add exact zeros to l and acc; padded query rows compute
//   on zero q rows and zero bias and are not stored.
// - q/k/v/o are read and written strided in their [B, L, H, D] layout (unit
//   stride on D, 16-byte aligned rows).

#include <math.h>

#include "flash_tiles.cuh"

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

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at head dim d and rel = W + Hg; the
// Python eligibility rule mirrors it.
size_t sav_rel_attention_smem_bytes(int d, int rel) {
  return smem_bytes(d, rel);
}

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
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
