// Blocked (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` with its epilogue `_online_softmax_step`
// in sav_tpu/ops/flash_attention.py (:86 / :57, host side `_flash_forward`,
// pallas_call at :233). Like it, one pass over the kv sequence in tiles,
// keeping a running max m, sum l and f32 accumulator per query row:
//
//   s      = (q . k) * scale (+ bias)   f32 product, THEN the scale
//   m_new  = max(m, rowmax(s));  alpha = exp(m - m_new)
//   p      = exp(s - m_new)              unnormalised
//   l      = alpha * l + rowsum(p)
//   acc    = alpha * acc + (p -> v dtype) . v
//   o      = acc / l on the last tile, then cast; lse = m + log l
//
// Columns past Lk exist only in the last tile and are masked to -inf there,
// so m is finite after every tile. The [B, H, Lq, Lk] scores never reach
// device memory, and any kv length fits.
//
// What bounds it on the H100: at the ViT-B/16 384² train shape (B=128,
// L=577, H=12, D=64, bf16) the function moves ~457 MB (q, k, v, o and the
// lse once each) and does ~131 GFLOP (two products), so the card's floor is
// ~0.14 ms, by bytes and operations alike. This kernel does not reach it:
// both products run on the CUDA cores in f32, not on the tensor cores. That
// is deliberate for a first kernel that must be right; mma/wgmma tiles are
// later work.
//
// Design:
// - Grid: one block per (batch*head slice, tile of 64 query rows), 256
//   threads as 16 x 16 with a 4 x 4 micro-tile each (flash_tiles.cuh).
// - The q tile is widened to f32 in shared memory once; K and V stream
//   through shared memory 64 rows at a time, each widened once on arrival.
// - Scores stay in registers; the row max and sum are half-warp shuffles
//   (the 16 threads of a row group); p goes to a shared f32 score tile,
//   rounded to the value dtype, for the PV product, whose accumulator stays
//   in registers for the whole kv sweep.
// - q/k/v/o are read and written strided in their [B, L, H, D] layout (unit
//   stride on D, 16-byte aligned rows), so stacked-QKV views need no copy.
// - The bias is read through four strides (batch, head, q, k); a broadcast
//   axis has stride 0, so (1,1) and (B,H) biases are never materialised.

#include <math.h>

#include "flash_tiles.cuh"

namespace {

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

// Dynamic shared memory of one block: f32 q, k and v tiles and the p tile.
__host__ __device__ inline size_t smem_bytes(int d) {
  return 3 * tile_bytes(d) + score_bytes();
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  float* qs = smem;
  float* ks = qs + kTile * tile_ld(D);
  float* vs = ks + kTile * tile_ld(D);
  float* ps = vs + kTile * tile_ld(D);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int nq = min(kTile, p.Lq - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2] +
                (int64_t)q0 * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* bg = p.bias != nullptr
                        ? p.bias + b * p.sb[0] + h * p.sb[1] +
                              (int64_t)q0 * p.sb[2]
                        : nullptr;
  load_tile<T>(qs, qg, p.sq[1], nq, D);

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.Lk; k0 += kTile) {
    const int nk = min(kTile, p.Lk - k0);
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<T>(ks, kg + (int64_t)k0 * p.sk[1], p.sk[1], nk, D);
    load_tile<T>(vs, vg + (int64_t)k0 * p.sv[1], p.sv[1], nk, D);
    __syncthreads();

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
        if (bg != nullptr && r < nq && c < nk)
          x += bg[r * p.sb[2] + (int64_t)(k0 + c) * p.sb[3]];
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
    if (p.lse != nullptr && tx == 0 && r < nq)
      p.lse[(size_t)bh * p.Lq + q0 + r] = m[i] + logf(l[i]);
  }
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2] +
          (int64_t)q0 * p.so[1];
  store_tile<T, NU>(og, p.so[1], nq, D, ty, tx, acc, 1.f);
}

template <typename T, int NU>
int launch_nu(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lq + kTile - 1) / kTile);
  flash_attention_fwd_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch_nu<T, 1>(p, stream) : launch_nu<T, 2>(p, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the Python eligibility rule mirrors it.
size_t sav_flash_attention_smem_bytes(int d) { return smem_bytes(d); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, in order
// q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), bias (b, h, q, k).
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_flash_attention_fwd(int dtype, const void* q, const void* k,
                            const void* v, const float* bias, void* o,
                            float* lse, int B, int H, int Lq, int Lk, int D,
                            const int64_t* strides, float scale,
                            void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 8 || D % 8 != 0 ||
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
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
