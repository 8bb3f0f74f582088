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
// and ~0.27 ms. These kernels do not reach them: every product runs on the
// CUDA cores in f32. That is deliberate for first kernels that must be
// right; mma/wgmma tiles are later work.
//
// Design (tile pieces in flash_tiles.cuh):
// - dq: one block per (batch*head slice, 64-row q tile) loops over the kv
//   tiles (the TPU's kv-innermost grid); q and dO stay in shared memory, k
//   and v stream through it, dq accumulates in registers.
// - dk/dv: one block per (batch*head slice, 64-row kv tile) loops over the q
//   tiles (the TPU's q-innermost grid); k and v stay, q, dO, lse and delta
//   stream, dk and dv accumulate in registers. The block computes the
//   transposed scores (kv rows by q columns), so p and ds land in shared
//   memory already in the layout the dv and dk products read.
// - Every output element has one owner, summed in a fixed order: no
//   atomics, and the same bits on every run (remat recomputes rely on it).
// - q/k/v/dO are read strided in their [B, L, H, D] layout (unit stride on
//   D, 16-byte aligned rows) and dq/dk/dv written the same way.

#include <math.h>

#include "flash_tiles.cuh"

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

// Dynamic shared memory of one block. dq: f32 q, dO, k and v tiles and the
// ds tile. dk/dv: f32 k, v, q and dO tiles, the p and ds tiles, and the q
// tile's lse and delta.
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

// Shared-memory bytes one block of each kernel needs; the Python
// eligibility rule mirrors both.
size_t sav_flash_attention_bwd_dq_smem_bytes(int d) { return dq_smem_bytes(d); }
size_t sav_flash_attention_bwd_dkv_smem_bytes(int d) {
  return dkv_smem_bytes(d);
}

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
  if (dtype == 1)
    return D <= 64 ? launch_dq<__nv_bfloat16, 1>(p, s)
                   : launch_dq<__nv_bfloat16, 2>(p, s);
  return D <= 64 ? launch_dq<float, 1>(p, s) : launch_dq<float, 2>(p, s);
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
  if (dtype == 1)
    return D <= 64 ? launch_dkv<__nv_bfloat16, 1>(p, s)
                   : launch_dkv<__nv_bfloat16, 2>(p, s);
  return D <= 64 ? launch_dkv<float, 1>(p, s) : launch_dkv<float, 2>(p, s);
}

}  // extern "C"
