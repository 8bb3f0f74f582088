// Element access and warp reductions shared by the port's kernels.
//
// Each kernel source includes this header and compiles into its own shared
// library, so the definitions live in an anonymous namespace per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Loads, stores and roundings of one storage dtype, widened to f32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float load(const float* p) { return *p; }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  // The cast to the storage dtype that the TPU kernels make before a
  // product (probabilities before PV, ds before dq/dk, ...).
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One head's [Lk, D] rows (strided, unit stride on D) into shared memory
// with 16-byte loads, each row padded by 16 bytes against bank conflicts.
template <typename T, int kThreads>
__device__ void load_kv(T* dst, const T* src, int64_t row_stride, int Lk,
                        int D) {
  constexpr int V = Elem<T>::kVec;
  const int chunks = D / V;
  const int stride = D + V;
  for (int i = threadIdx.x; i < Lk * chunks; i += kThreads) {
    const int j = i / chunks;
    const int c = i - j * chunks;
    *reinterpret_cast<uint4*>(dst + (size_t)j * stride + c * V) =
        *reinterpret_cast<const uint4*>(src + j * row_stride + c * V);
  }
}

// The tile's rows of one head ([L, D] strided, in T) widened to f32; rows at
// or past `nrows` are zero.
template <typename T, int kThreads>
__device__ void load_rows(float* dst, const T* src, int64_t row_stride,
                          int kTile, int nrows, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[i] = r < nrows ? Elem<T>::load(src + r * row_stride + d) : 0.f;
  }
}

// out[r][j] = (x_r . kv_j) * scale for the warp's R rows starting at row0;
// lanes stride over the kv columns and reuse each chunk for R rows.
template <typename T, int R>
__device__ void rows_dot(const float* xs, const T* kv, int row0, int D,
                         int Lk, float* out, size_t out_rstride, float scale,
                         int lane) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  const int chunks = D / V;
  const int kstride = D + V;
  for (int j = lane; j < Lk; j += 32) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const T* krow = kv + (size_t)j * kstride;
    for (int c = 0; c < chunks; ++c) {
      float kf[V];
      E::unpack(*reinterpret_cast<const uint4*>(krow + c * V), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* xv =
            reinterpret_cast<const float4*>(xs + (row0 + r) * D + c * V);
#pragma unroll
        for (int e = 0; e < V / 4; ++e) {
          const float4 x = xv[e];
          acc[r] = fmaf(x.x, kf[4 * e], acc[r]);
          acc[r] = fmaf(x.y, kf[4 * e + 1], acc[r]);
          acc[r] = fmaf(x.z, kf[4 * e + 2], acc[r]);
          acc[r] = fmaf(x.w, kf[4 * e + 3], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[r * out_rstride + j] = acc[r] * scale;
  }
}

}  // namespace
