// Tile pieces shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) and the relative-position kernels built on them
// (rel_attention.cu, rel_attention_bwd.cu).
//
// A block of kThreads = 256 threads works on 64 x 64 tiles as a 16 x 16 grid
// of threads, thread (ty, tx) = (tid / 16, tid % 16), each owning a 4 x 4
// micro-tile:
//
// - scores (tile_dot): rows 4*ty + i of operand A and rows tx + 16*j of
//   operand B, both f32 [64][ld] in shared memory with ld = D + 4, read as
//   float4 along D. A's rows are a broadcast within each half-warp; B's rows
//   sit 16 bytes apart modulo the 32 banks (ld = 4 mod 8), so a quarter-warp
//   reads 8 distinct bank groups: no conflicts.
// - products with a value-like operand (tile_pv): out[4*ty + i][4*tx + 64*u
//   + e] += sum_j P[4*ty + i][j] * X[j][4*tx + 64*u + e], P an f32 [64][kLdS]
//   score tile, X f32 [64][ld]; NU = ceil(D / 64) column groups per thread.
//
// Every tile is f32 in shared memory whatever the input dtype: inputs are
// widened once as they arrive (16-byte loads), and every product sums in
// f32 on the CUDA cores.

#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 64;        // q rows per block, kv rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kMaxDim = 128;     // largest head dim (NU <= 2)
constexpr int kLdS = kTile + 4;  // row stride of a score tile, in f32

__host__ __device__ inline int tile_ld(int d) { return d + 4; }

// Bytes of one f32 [64][D + 4] operand tile and of one [64][68] score tile.
__host__ __device__ inline size_t tile_bytes(int d) {
  return (size_t)kTile * tile_ld(d) * sizeof(float);
}
__host__ __device__ inline size_t score_bytes() {
  return (size_t)kTile * kLdS * sizeof(float);
}

// f32 rows of the relative-position kernels' compact logits for one q tile:
// 64 * rel floats, rel = W + Hg (rel_attention.cu, rel_attention_bwd.cu).
__host__ __device__ inline size_t rel_rows_bytes(int rel) {
  return (size_t)kTile * rel * sizeof(float);
}

// `n` consecutive floats from global memory into shared memory, zero past
// `valid`.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int n, int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = i < valid ? src[i] : 0.f;
}

// `nrows` rows of one head ([L, D] strided, unit stride on D, 16-byte
// aligned rows) widened into the f32 tile dst[64][ld]; rows past `nrows`
// are zero, so masked products add exact zeros.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int64_t row_stride,
                          int nrows, int D) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  const int chunks = D / V;
  const int ld = tile_ld(D);
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    float f[V];
    if (r < nrows) {
      E::unpack(*reinterpret_cast<const uint4*>(src + r * row_stride + c * V),
                f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c * V);
#pragma unroll
    for (int e = 0; e < V / 4; ++e)
      out[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
  }
}

// acc[i][j] = A[4*ty + i] . B[tx + 16*j] over D, in f32.
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int D, int ty, int tx,
                                         float acc[4][4]) {
  const int ld = tile_ld(D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a0 = A + 4 * ty * ld;
  const float* b0 = B + tx * ld;
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a0 + i * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][u] += sum over the 64 rows j of P[4*ty + i][j] * X[j][4*tx + 64*u
// .. + 3], for the column groups inside D.
template <int NU>
__device__ __forceinline__ void tile_pv(const float* P, const float* X,
                                        int D, int ty, int tx,
                                        float4 acc[4][NU]) {
  const int ld = tile_ld(D);
  const float* p0 = P + 4 * ty * kLdS;
  for (int j = 0; j < kTile; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(p0 + i * kLdS + j);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = 4 * tx + 64 * u;
      if (c < D) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 x =
              *reinterpret_cast<const float4*>(X + (j + jj) * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = jj == 0   ? p[i].x
                            : jj == 1 ? p[i].y
                            : jj == 2 ? p[i].z
                                      : p[i].w;
            acc[i][u].x = fmaf(w, x.x, acc[i][u].x);
            acc[i][u].y = fmaf(w, x.y, acc[i][u].y);
            acc[i][u].z = fmaf(w, x.z, acc[i][u].z);
            acc[i][u].w = fmaf(w, x.w, acc[i][u].w);
          }
        }
      }
    }
  }
}

// Reductions over the 16 threads of a half-warp that share a row group.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stores a thread's 4 x NU float4 micro-tile (times `mul`) to rows
// 4*ty + i (of `nrows`) of a strided [L, D] output.
template <typename T, int NU>
__device__ __forceinline__ void store_tile(T* dst, int64_t row_stride,
                                           int nrows, int D, int ty, int tx,
                                           const float4 acc[4][NU],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = 4 * tx + 64 * u;
      if (c < D) {
        T* out = dst + r * row_stride + c;
        Elem<T>::store(out + 0, acc[i][u].x * mul);
        Elem<T>::store(out + 1, acc[i][u].y * mul);
        Elem<T>::store(out + 2, acc[i][u].z * mul);
        Elem<T>::store(out + 3, acc[i][u].w * mul);
      }
    }
  }
}

}  // namespace
