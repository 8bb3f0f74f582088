// Per-channel symmetric int8 quantization for Hopper (sm_90a): kernel Q1 of
// the int8 arm.
//
// Replaces no TPU kernel: sav_tpu leaves `quantize_channelwise` and
// `quantize_stochastic` (sav_tpu/ops/quant.py:64-92) to XLA's fusion. It
// computes, per channel, amax = max |a| over the contracted axis, scale =
// amax / 127 (1.0 where amax is 0), and the codes clip(round(a / scale))
// (round half to even, as jnp.round) or, with uniform draws u passed in,
// clip(floor(a / scale + u)) (the stochastic rounding of the gradient), to
// int8 in [-127, 127]. Every operation is the f32 one of the reference:
// IEEE division (__fdiv_rn), rintf, floorf, __fadd_rn; so the codes and the
// scales are bit-equal to the plain version.
//
// Two layouts, one C entry point each:
//
// - rows (`sav_int8_quantize_rows`): a [R, C] matrix (row stride `lda`),
//   one scale per row (the contracted axis is C). One warp per row: the
//   first sweep takes the row's amax (warp shuffles), the second writes
//   the codes. Codes are [R, ldc] with ldc >= C; columns C..ldc-1 are
//   written 0, so the GEMM (int8_gemm.cu) reads whole 16-byte chunks.
// - columns, transposed (`sav_int8_quantize_cols_t`): a [T, R, C] tensor
//   (contiguous), one scale per (t, column) (the contracted axis is R);
//   the codes are written transposed, [T, C, ldc] with ldc >= R (rows R..
//   ldc-1 zero), so the GEMM gets this operand K-contiguous too. Two
//   kernels: the first writes each 256-row chunk's column amax to a scratch
//   [T, chunks, C] (no atomics: the max of a column does not depend on any
//   order), the second reduces a column's chunks, forms its scale and
//   quantizes a 32 x 32 tile, transposed through shared memory. Both
//   kernels count as one launch of Q1.
//
// What bounds it on the H100: bytes. It reads the input once (twice for the
// transposed layout: the amax pass and the quantize pass, the second mostly
// from L2) and writes a byte per element plus the scales; at the DeiT-S
// train shape (x: 50,432 x 384 bf16) that is ~58 MB moved, ~0.017 ms at
// 3.35 TB/s. The design is plain: scalar loads, coalesced along C, and a
// tile transpose for the other layout.

#include "common.cuh"

namespace {

constexpr float kInt8Amax = 127.0f;
constexpr int kRowWarps = 8;
constexpr int kColChunk = 256;  // rows per partial amax
constexpr int kTile = 32;

__device__ __forceinline__ float channel_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, kInt8Amax) : 1.0f;
}

__device__ __forceinline__ int8_t quantize_one(float a, float scale,
                                               const float* noise,
                                               size_t index) {
  float v = __fdiv_rn(a, scale);
  v = noise ? floorf(__fadd_rn(v, noise[index])) : rintf(v);
  v = fminf(fmaxf(v, -kInt8Amax), kInt8Amax);
  return static_cast<int8_t>(static_cast<int>(v));
}

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ a,
                                     const float* __restrict__ noise,
                                     int8_t* __restrict__ codes,
                                     float* __restrict__ scales, int R, int C,
                                     int64_t lda, int64_t ldc) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* src = a + (size_t)row * lda;
  float amax = 0.f;
  for (int c = lane; c < C; c += 32)
    amax = fmaxf(amax, fabsf(Elem<T>::load(src + c)));
  amax = warp_max(amax);
  const float scale = channel_scale(amax);
  if (lane == 0) scales[row] = scale;
  int8_t* dst = codes + (size_t)row * ldc;
  const float* row_noise = noise ? noise + (size_t)row * C : nullptr;
  for (int c = lane; c < ldc; c += 32)
    dst[c] = c < C ? quantize_one(Elem<T>::load(src + c), scale, row_noise, c)
                   : int8_t(0);
}

// partial[t][chunk][c] = max |a[t][r][c]| over the chunk's rows.
template <typename T>
__global__ void cols_amax_kernel(const T* __restrict__ a,
                                 float* __restrict__ partial, int R, int C) {
  __shared__ float red[8][kTile];
  const int t = blockIdx.z;
  const int c = blockIdx.x * kTile + threadIdx.x;
  const int r0 = blockIdx.y * kColChunk;
  const int r1 = min(R, r0 + kColChunk);
  const T* src = a + (size_t)t * R * C;
  float amax = 0.f;
  if (c < C)
    for (int r = r0 + threadIdx.y; r < r1; r += 8)
      amax = fmaxf(amax, fabsf(Elem<T>::load(src + (size_t)r * C + c)));
  red[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
#pragma unroll
    for (int i = 1; i < 8; ++i) amax = fmaxf(amax, red[i][threadIdx.x]);
    partial[((size_t)t * gridDim.y + blockIdx.y) * C + c] = amax;
  }
}

// codes[t][c][r] for the block's 32 x 32 tile (rows r past R, up to ldc,
// written 0); the blocks of the first row of tiles write the scales.
template <typename T>
__global__ void cols_quant_kernel(const T* __restrict__ a,
                                  const float* __restrict__ partial,
                                  const float* __restrict__ noise,
                                  int8_t* __restrict__ codes,
                                  float* __restrict__ scales, int R, int C,
                                  int chunks, int64_t ldc) {
  __shared__ float red[8][kTile];
  __shared__ float scale_s[kTile];
  __shared__ int8_t tile[kTile][kTile + 4];
  const int t = blockIdx.z;
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  const int c = c0 + threadIdx.x;
  float amax = 0.f;
  if (c < C)
    for (int k = threadIdx.y; k < chunks; k += 8)
      amax = fmaxf(amax, partial[((size_t)t * chunks + k) * C + c]);
  red[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int i = 1; i < 8; ++i) amax = fmaxf(amax, red[i][threadIdx.x]);
    const float scale = channel_scale(amax);
    scale_s[threadIdx.x] = scale;
    if (blockIdx.y == 0 && c < C) scales[(size_t)t * C + c] = scale;
  }
  __syncthreads();
  const T* src = a + (size_t)t * R * C;
  const float* tnoise = noise ? noise + (size_t)t * R * C : nullptr;
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int r = r0 + i;
    int8_t q = 0;
    if (r < R && c < C) {
      const size_t index = (size_t)r * C + c;
      q = quantize_one(Elem<T>::load(src + index), scale_s[threadIdx.x],
                       tnoise, index);
    }
    tile[i][threadIdx.x] = q;
  }
  __syncthreads();
  int8_t* dst = codes + (size_t)t * C * ldc;
  for (int i = threadIdx.y; i < kTile; i += 8) {
    const int cc = c0 + i;
    const int r = r0 + threadIdx.x;
    if (cc < C && r < ldc) dst[(size_t)cc * ldc + r] = tile[threadIdx.x][i];
  }
}

template <typename T>
int launch_rows(const void* a, const float* noise, int8_t* codes,
                float* scales, int R, int C, int64_t lda, int64_t ldc,
                cudaStream_t stream) {
  const int blocks = (R + kRowWarps - 1) / kRowWarps;
  quantize_rows_kernel<T><<<blocks, 32 * kRowWarps, 0, stream>>>(
      static_cast<const T*>(a), noise, codes, scales, R, C, lda, ldc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cols(const void* a, const float* noise, int8_t* codes,
                float* scales, float* partial, int Tn, int R, int C,
                int64_t ldc, cudaStream_t stream) {
  const int chunks = (R + kColChunk - 1) / kColChunk;
  const dim3 block(kTile, 8);
  cols_amax_kernel<T><<<dim3((C + kTile - 1) / kTile, chunks, Tn), block, 0,
                        stream>>>(static_cast<const T*>(a), partial, R, C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cols_quant_kernel<T><<<dim3((C + kTile - 1) / kTile,
                              (int)((ldc + kTile - 1) / kTile), Tn),
                         block, 0, stream>>>(static_cast<const T*>(a), partial,
                                             noise, codes, scales, R, C,
                                             chunks, ldc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of the scratch `sav_int8_quantize_cols_t` needs: T * chunks * C.
size_t sav_int8_quantize_cols_scratch(int Tn, int R, int C) {
  return (size_t)Tn * ((R + kColChunk - 1) / kColChunk) * C;
}

// dtype: 0 = float32, 1 = bfloat16. a: [R, C] with row stride lda
// (elements); noise: null (round to nearest even) or [R, C] contiguous f32
// draws in [0, 1); codes: [R, ldc] int8, ldc >= C; scales: [R] f32.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_int8_quantize_rows(int dtype, const void* a, const float* noise,
                           void* codes, float* scales, int R, int C,
                           int64_t lda, int64_t ldc, void* stream) {
  if (R < 1 || C < 1 || lda < C || ldc < C || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(codes);
  return dtype == 1
             ? launch_rows<__nv_bfloat16>(a, noise, q, scales, R, C, lda, ldc,
                                          s)
             : launch_rows<float>(a, noise, q, scales, R, C, lda, ldc, s);
}

// a: [T, R, C] contiguous; noise: null or [T, R, C] f32; codes: [T, C, ldc]
// int8, ldc >= R; scales: [T, C] f32; partial: the scratch of
// `sav_int8_quantize_cols_scratch` floats.
int sav_int8_quantize_cols_t(int dtype, const void* a, const float* noise,
                             void* codes, float* scales, float* partial,
                             int Tn, int R, int C, int64_t ldc, void* stream) {
  if (Tn < 1 || R < 1 || C < 1 || ldc < R || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(codes);
  return dtype == 1 ? launch_cols<__nv_bfloat16>(a, noise, q, scales, partial,
                                                 Tn, R, C, ldc, s)
                    : launch_cols<float>(a, noise, q, scales, partial, Tn, R,
                                         C, ldc, s);
}

}  // extern "C"
